# Copied from tcforge_tpu/modules/encoders/encoder_cfg.py lines 18-21 and 24-24 and 40-57; split_extra_options alone (the port reads no encoder cfg file), only the package name in its imports differs.
from __future__ import annotations

from typing import Dict, Optional, Tuple

from tcforge_tpu_torch.core.optstr import ModuleDesc, parse_optstr


def split_extra_options(desc: ModuleDesc,
                        options: str) -> Tuple[str, Dict[str, str]]:
    """Split a module option string into (known-params optstring,
    extra key→value dict).  The reference modules feed the full
    string through their cfg table; our ModuleDesc carries only the
    engine-level params, so free-form codec options are carved out
    before the strict parse."""
    raw = parse_optstr(options)
    known = {p.name for p in desc.params} | {"help"}
    keep, extra = [], {}
    for k, v in raw.items():
        if k in known:
            keep.append(f"{k}={v}" if v != "" else k)
        else:
            extra[k] = v
    return ":".join(keep), extra
