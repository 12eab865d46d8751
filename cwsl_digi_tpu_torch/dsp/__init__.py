"""dsp layer of the PyTorch port (see cwsl_digi_tpu/dsp)."""

from cwsl_digi_tpu_torch.dsp.lowpass import build_lowpass  # noqa: F401
from cwsl_digi_tpu_torch.dsp.ssbd import SSBD  # noqa: F401
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer, ChannelizerSpec  # noqa: F401
