"""sdr layer of the PyTorch port: IQ sources (copies of cwsl_digi_tpu/sdr)."""
