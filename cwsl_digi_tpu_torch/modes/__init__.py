"""modes layer of the PyTorch port (see cwsl_digi_tpu/modes)."""
