"""Small config-value parsers (a copy of ``hcpdiff_tpu/utils/cfg_parse.py``)."""
from __future__ import annotations

from typing import Tuple


def get_cfg_range(cfg_text: str) -> Tuple[float, float, str]:
    """'1.0-3.0:cos' -> (1.0, 3.0, 'cos'); '5.0' -> (5.0, 5.0, 'linear')."""
    ramp = 'linear'
    text = str(cfg_text)
    if ':' in text:
        text, ramp = text.split(':', 1)
    if '-' in text.lstrip('-'):
        # split on the dash separating two numbers (careful with negatives)
        i = text.index('-', 1)
        lo, hi = float(text[:i]), float(text[i + 1:])
    else:
        lo = hi = float(text)
    return lo, hi, ramp
