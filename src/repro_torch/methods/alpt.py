"""ALPT: LPT + a learned per-row Delta (port of repro/methods/alpt.py).

ALPT starts Delta from the LSQ-style init instead of a clip value; the
Algorithm 1 train step comes with the training slice.  Serving ships the
codes and the learned Delta as they are (inherited ``serving_state``).
"""
from __future__ import annotations

from repro_torch.methods.base import register
from repro_torch.methods.lpt import LPTMethod


@register("alpt")
class ALPTMethod(LPTMethod):
    # ALPT learns Delta from the LSQ-style init; the clip knob is LPT-only.
    _clip_value_of = staticmethod(lambda spec: None)
