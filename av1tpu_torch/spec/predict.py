"""Intra prediction constants (copy of the tables of av1tpu/spec/predict.py
that the wavefront keyframe reads; spec 7.11.2)."""

from __future__ import annotations

import numpy as np

from av1tpu_torch.spec.enums import (
    D45_PRED, D67_PRED, D113_PRED, D135_PRED, D157_PRED, D203_PRED, H_PRED,
    V_PRED,
)

# Dr_Intra_Derivative (spec 7.11.2.4): 1/64-pel per-row (or per-column)
# steps of the directional predictors, indexed by angle mod 90
DR_INTRA_DERIVATIVE = {
    3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151, 26: 132,
    29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64, 48: 57, 51: 51,
    54: 45, 58: 40, 61: 35, 64: 31, 67: 27, 70: 23, 73: 19, 76: 15,
    81: 11, 84: 7, 87: 3,
}

# base prediction angle per directional mode (spec Mode_To_Angle)
MODE_ANGLE = {V_PRED: 90, H_PRED: 180, D45_PRED: 45, D135_PRED: 135,
              D113_PRED: 113, D157_PRED: 157, D203_PRED: 203,
              D67_PRED: 67}

# smooth predictor weights (spec Sm_Weights_Tx_*), for the transform sizes
# the keyframe codes luma at
SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], np.int64),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.int64),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33,
                  26, 20, 17, 16], np.int64),
}
