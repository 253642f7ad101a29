"""Config presets mirroring the reference's driver configs (BASELINE.json).

The port's presets (hipie_torch/presets.py) that the benchmark's
configurations name, over hipie_plain.config. Reference yaml sources:
projects/HIPIE/configs/training/r50.yaml and vit_huge_32g.yaml.
"""

from __future__ import annotations

from hipie_plain.config import HIPIEConfig, apply_overrides


def r50_coco_panoptic() -> HIPIEConfig:
    """Stage-2 joint R50 config (r50.yaml): 900 fg + 10 bg queries, DN 100,
    MaskDINO decoupled decoder, OTA fg matching, IoU head, still-cls encoder."""
    return apply_overrides(HIPIEConfig(), {
        "model.backbone.name": "resnet50",
        "model.still_cls_for_encoder": True,
        "model.num_classes": 80,
    })


def vit_huge_coco_panoptic() -> HIPIEConfig:
    """ViT-H flagship (vit_huge_32g.yaml): backbone swap + act-ckpt."""
    cfg = r50_coco_panoptic()
    return apply_overrides(cfg, {
        "model.backbone.name": "vit_huge",
        "model.backbone.vit_remat": True,
        "model.transformer.remat": True,
    })
