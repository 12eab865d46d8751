"""utils layer of the PyTorch port: host utilities (copies of
cwsl_digi_tpu/utils)."""
