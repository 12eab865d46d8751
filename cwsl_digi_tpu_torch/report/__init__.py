"""report layer of the PyTorch port: spots and reporters (copies of
cwsl_digi_tpu/report)."""
