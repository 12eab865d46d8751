"""Config layer: INI file + command-line overrides with the reference's keys.

Reference parity: source/CWSL_DIGI.cpp:534-1063 (boost::program_options over
an INI file; every key also works as ``--section.key`` on the command line;
unknown INI keys are tolerated).  Sections and defaults mirror
/root/reference/config.ini.

Decoder-line grammar (reference: source/CWSL_DIGI.cpp:731-836,
config.ini:29-41)::

    decoder=<freq Hz> <mode> [<sharedmem #>] [<freqcal>] [<wsprcall>]

A calibrated frequency is ``freq / (freqcalibration_global * freqcal)``
(reference: source/CWSL_DIGI.cpp:834).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from pathlib import Path
from typing import Any, Optional

from cwsl_digi_tpu_torch.constants import Mode, get_rx_period, parse_mode


@dataclasses.dataclass
class DecoderLine:
    """One configured channel (reference: class Decoder, source/Decoder.hpp:31-71)."""

    freq: int                      # dial frequency, Hz
    mode: Mode
    smnum: int = -1                # shared memory / capture-source number (-1 = auto)
    freq_cal: float = 1.0          # per-decoder calibration factor
    wspr_call: str = ""            # per-WSPR reporter callsign override

    @property
    def calibrated_freq(self) -> float:
        return self.freq / self.freq_cal

    @property
    def trperiod(self) -> float:
        return get_rx_period(self.mode)


_DEFAULTS: dict[str, dict[str, Any]] = {
    # Section -> key -> default, matching /root/reference/config.ini comments.
    "radio": {"freqcalibration": 1.0, "sharedmem": -1},
    "operator": {"callsign": "", "gridsquare": ""},
    "decoders": {"decoders": []},
    "wsjtx": {
        "decoderburden": 1.0,
        "maxdataage": 10,             # x T/R; config.ini:177-181
        "numjt9instances": -1,        # -1 = auto heuristic
        "maxwsprdinstances": -1,
        "numjt9threads": 3,           # config.ini:205-207
        "keepwav": False,             # config.ini:209-211
        "decodedepth": 3,             # config.ini:213-215
        "wsprcycles": 3000,           # config.ini:217-222
        "highestdecodefreq": 3000,
        "binpath": "",
        "temppath": "",
        "transfermethod": "shmem",    # config.ini:147-164 (no-op here: no
                                      # child processes; tolerated for compat)
        "ftaudioscalefactor": 0.90,   # config.ini:166-175
        "wspraudioscalefactor": 0.20,
    },
    "js8call": {"binpath": ""},
    # framework-specific section (not in the reference's config.ini):
    # TPU compute-backend knobs
    "tpu": {
        "channelizer": "xla",         # xla only: the pallas kernel lost
                                      # the bench-off and was demoted
                                      # (bench.py still measures both)
    },
    "reporting": {
        "pskreporter": False,
        "wsprnet": False,
        "rbn": False,                 # config.ini:238-240
        "aggregatorip": "127.0.0.1",  # config.ini:241-245
        "aggregatorport": 2215,
        "ignoredcalls": "",           # space-separated list, config.ini:247-251
    },
    "logging": {
        "loglevel": 3,
        "logimmediately": False,
        "logfile": "",
        "printjt9output": False,
        "decodesfile": "",
        "badmsglog": "",
        "logreports": True,
        "statsreportinginterval": 300,  # config.ini:256-258
    },
}


def _coerce(default: Any, raw: str) -> Any:
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(float(raw))
    if isinstance(default, float):
        return float(raw)
    return raw


def parse_decoder_line(line: str) -> DecoderLine:
    """Parse ``freq mode [shmem] [freqcal] [wsprcall]``
    (reference: source/CWSL_DIGI.cpp:731-836)."""
    parts = line.split()
    if len(parts) < 2:
        raise ValueError(f"bad decoder line: {line!r}")
    freq = int(float(parts[0]))
    mode = parse_mode(parts[1])
    smnum = int(parts[2]) if len(parts) > 2 else -1
    freq_cal = float(parts[3]) if len(parts) > 3 else 1.0
    wspr_call = parts[4] if len(parts) > 4 else ""
    if freq_cal <= 0:
        raise ValueError(f"freqcal must be > 0 in decoder line: {line!r}")
    return DecoderLine(freq, mode, smnum, freq_cal, wspr_call)


class Config:
    """Parsed configuration with attribute access ``cfg.get(section, key)``."""

    def __init__(self, values: dict[str, dict[str, Any]]):
        self._values = values

    def get(self, section: str, key: str) -> Any:
        return self._values[section][key]

    def set(self, section: str, key: str, value: Any) -> None:
        self._values.setdefault(section, {})[key] = value

    @property
    def decoders(self) -> list[DecoderLine]:
        return list(self._values["decoders"]["decoders"])

    # -- derived sizing heuristics -----------------------------------------

    def num_decode_slots(self) -> int:
        """Worker-pool sizing heuristic, kept for capacity planning parity.

        Reference: numJT9Instances = round((nFT4+nFT8+nQ65+nJS8)/5 +
        (nWSPR+nJT65+nFST4W+nFST4)/3) * decoderburden + 0.55)
        (source/CWSL_DIGI.cpp:856-868).  In the TPU build this sizes the
        number of concurrent device-batch slots, not OS processes.
        """
        override = int(self.get("wsjtx", "numjt9instances"))
        if override > 0:
            return override
        n_fast = sum(
            1 for d in self.decoders
            if d.mode in (Mode.FT8, Mode.FT4, Mode.Q65_30, Mode.JS8)
        )
        n_slow = len(self.decoders) - n_fast
        burden = float(self.get("wsjtx", "decoderburden"))
        n = round((n_fast / 5.0 + n_slow / 3.0) * burden + 0.55)
        return max(1, int(n))

    def max_long_slots(self) -> int:
        """Reference: maxWSPRDInstances = round(numJT9Instances * nWSPR/n),
        min 1 if any WSPR (source/CWSL_DIGI.cpp:871-885)."""
        override = int(self.get("wsjtx", "maxwsprdinstances"))
        if override > 0:
            return override
        n_total = len(self.decoders)
        n_wspr = sum(1 for d in self.decoders if d.mode == Mode.WSPR)
        if n_total == 0 or n_wspr == 0:
            return 0
        return max(1, round(self.num_decode_slots() * n_wspr / n_total))


def default_config() -> Config:
    values = {s: dict(kv) for s, kv in _DEFAULTS.items()}
    values["decoders"]["decoders"] = []
    return Config(values)


def load_config(
    path: Optional[str | Path] = None,
    overrides: Optional[list[str]] = None,
) -> Config:
    """Load INI + ``section.key=value`` overrides.

    Search order mirrors the reference (source/CWSL_DIGI.cpp:583-603):
    explicit path -> $CWSL_DIGI_TPU_CONFIG -> ./config.ini.
    Unknown keys are tolerated (reference passes allow_unregistered=true).
    """
    cfg = default_config()
    candidates: list[Path] = []
    if path:
        candidates.append(Path(path))
    env = os.environ.get("CWSL_DIGI_TPU_CONFIG")
    if env:
        candidates.append(Path(env))
    candidates.append(Path("config.ini"))

    ini_path = next((p for p in candidates if p.is_file()), None)
    if ini_path is not None:
        _merge_ini(cfg, ini_path)
    for ov in overrides or []:
        _apply_override(cfg, ov)
    return cfg


def _merge_ini(cfg: Config, path: Path) -> None:
    parser = configparser.ConfigParser(strict=False)
    # The reference's INI has repeated `decoder=` keys; configparser cannot
    # hold duplicates, so collect them manually first.
    decoder_lines: list[str] = []
    text_lines = []
    current_section = ""
    for raw in path.read_text().splitlines():
        stripped = raw.strip()
        if stripped.startswith("[") and stripped.endswith("]"):
            current_section = stripped[1:-1].lower()
        if (
            current_section == "decoders"
            and "=" in stripped
            and stripped.split("=", 1)[0].strip().lower() == "decoder"
            and not stripped.startswith(("#", ";"))
        ):
            decoder_lines.append(stripped.split("=", 1)[1].strip())
            continue
        text_lines.append(raw)
    parser.read_string("\n".join(text_lines))

    for section in parser.sections():
        s = section.lower()
        for key, raw_val in parser.items(section):
            k = key.lower()
            if s in _DEFAULTS and k in _DEFAULTS[s]:
                cfg.set(s, k, _coerce(_DEFAULTS[s][k], raw_val))
            else:
                cfg.set(s, k, raw_val)  # tolerated unknown key
    lines = [parse_decoder_line(l) for l in decoder_lines]
    # calibrated = freq / (freqcalibration_global * freqcal_decoder)
    # (reference: source/CWSL_DIGI.cpp:834) — fold the global factor in
    cal_global = float(cfg.get("radio", "freqcalibration"))
    if cal_global > 0 and cal_global != 1.0:
        for line in lines:
            line.freq_cal *= cal_global
    cfg.set("decoders", "decoders", lines)


def _apply_override(cfg: Config, override: str) -> None:
    """Apply ``section.key=value`` (the reference exposes the same keys as
    ``--section.key`` flags, source/CWSL_DIGI.cpp:537-574)."""
    key, _, value = override.partition("=")
    section, _, k = key.strip().partition(".")
    section, k = section.lower(), k.lower()
    if section == "decoders" and k == "decoder":
        lines = cfg.decoders + [parse_decoder_line(value)]
        cfg.set("decoders", "decoders", lines)
        return
    default = _DEFAULTS.get(section, {}).get(k)
    cfg.set(section, k, _coerce(default, value) if default is not None else value)
