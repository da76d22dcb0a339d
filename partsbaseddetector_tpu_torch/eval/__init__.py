"""Evaluation: PCK / APK / VOC AP and model test harnesses."""

from .metrics import (
    best_overlap,
    boxes_to_keypoints,
    eval_apk,
    eval_pck,
    test_model,
    test_model_gtbox,
    voc_ap,
)
