"""Device utilities (``mlio_tpu/utils``)."""
