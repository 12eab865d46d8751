"""utils layer of the PyTorch port: host utilities (copies of
cwsl_digi_tpu/utils)."""

from cwsl_digi_tpu_torch.utils import hamutils, stringutils, timeutils, wav  # noqa: F401
from cwsl_digi_tpu_torch.utils.logging import LogLevel, ScreenPrinter  # noqa: F401
