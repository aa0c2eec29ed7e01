# Copied from tcforge_tpu/core/ratiocodes.py; only the package name in its imports differs.
"""Frame-rate (frc), display-aspect (asr) and pixel-aspect (par) code tables.

Re-implementation of ``libtc/ratiocodes.[ch]``.  Table contents mirror
``ratiocodes.c:36-116`` exactly; the codes are MPEG-style indices used by
probe output and the job record.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

# frc code -> fps ratio (num, den); ratiocodes.c:69-88
FRC_RATIOS: Tuple[Tuple[int, int], ...] = (
    (0, 0),
    (24000, 1001),
    (24000, 1000),
    (25000, 1000),
    (30000, 1001),
    (30000, 1000),
    (50000, 1000),
    (60000, 1001),
    (60000, 1000),
    (1000, 1000),
    (5000, 1000),
    (10000, 1000),
    (12000, 1000),
    (15000, 1000),
    (0, 0),
    (0, 0),
)

# asr code -> display aspect ratio; ratiocodes.c:91-105
ASR_RATIOS: Tuple[Tuple[int, int], ...] = (
    (0, 0), (1, 1), (4, 3), (16, 9), (221, 100),
    (0, 0), (0, 0), (0, 0),
)

# par code -> pixel aspect ratio; ratiocodes.c:107-116
PAR_RATIOS: Tuple[Tuple[int, int], ...] = (
    (1, 1), (1, 1), (1200, 1100), (1000, 1100), (1600, 1100),
    (4000, 3300), (1, 1), (1, 1),
)

# Comparison tolerance used by tc_guess_code_from_value.
_EPSILON = 1e-4


def _value(pair: Tuple[int, int]) -> float:
    num, den = pair
    return num / den if den else 0.0


def frc_code_to_value(code: int) -> Optional[float]:
    """tc_frc_code_to_value: frc code -> fps, None if out of range."""
    if 0 <= code < len(FRC_RATIOS):
        return _value(FRC_RATIOS[code])
    return None


def frc_code_from_value(fps: float) -> Optional[int]:
    """tc_frc_code_from_value: fps -> frc code, None if no match."""
    for code, pair in enumerate(FRC_RATIOS):
        if pair != (0, 0) and abs(_value(pair) - fps) < _EPSILON:
            return code
    return None


def frc_code_to_ratio(code: int) -> Optional[Tuple[int, int]]:
    if 0 <= code < len(FRC_RATIOS) and FRC_RATIOS[code] != (0, 0):
        return FRC_RATIOS[code]
    return None


def frc_code_from_ratio(num: int, den: int) -> Optional[int]:
    target = Fraction(num, den) if den else None
    if target is None:
        return None
    for code, (n, d) in enumerate(FRC_RATIOS):
        if d and Fraction(n, d) == target:
            return code
    return None


def asr_code_to_ratio(code: int) -> Optional[Tuple[int, int]]:
    if 0 <= code < len(ASR_RATIOS) and ASR_RATIOS[code] != (0, 0):
        return ASR_RATIOS[code]
    return None


def asr_code_from_value(ratio: float) -> Optional[int]:
    for code, pair in enumerate(ASR_RATIOS):
        if pair != (0, 0) and abs(_value(pair) - ratio) < _EPSILON:
            return code
    return None


def par_code_to_ratio(code: int) -> Optional[Tuple[int, int]]:
    if 0 <= code < len(PAR_RATIOS):
        return PAR_RATIOS[code]
    return None


def asr_code_describe(code: int) -> str:
    """tc_asr_code_describe (ratiocodes.c:120-140)."""
    return {
        1: "encoded @ 1:1",
        2: "encoded @ 4:3",
        3: "encoded @ 16:9",
        4: "encoded @ 2.21:1",
    }.get(code, "unknown")


# Common named rates for convenience.
FPS_FILM = 24000 / 1001     # frc 1
FPS_PAL = 25.0              # frc 3
FPS_NTSC = 30000 / 1001     # frc 4
