"""Program identity (reference: source/CWSL_DIGI.hpp:41-42)."""

PROGRAM_NAME = "CWSL_DIGI_TPU"
__version__ = "0.1.0"
# Reference program/version the capability set tracks.
REFERENCE_PROGRAM = "CWSL_DIGI"
REFERENCE_VERSION = "0.88"
