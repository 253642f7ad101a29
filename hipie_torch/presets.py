"""Config presets mirroring the reference's driver configs (BASELINE.json).

Counterpart of hipie_tpu/presets.py; the same presets over hipie_torch.config.

reference yaml sources: projects/HIPIE/configs/training/r50.yaml,
vit_huge_32g.yaml, configs/eval/image_joint_r50_pan_maskdino_pascal.yaml, and
the nested maskdino_R50_bs16_50ep_3s_dowsample1_2048.yaml.
"""

from __future__ import annotations

from hipie_torch.config import HIPIEConfig, apply_overrides


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


def swin_large_coco_panoptic() -> HIPIEConfig:
    """Swin-L backbone variant (reference hipie/backbone/swin.py is a
    first-class MODEL.BACKBONE option; smoke config for the converter)."""
    cfg = r50_coco_panoptic()
    return apply_overrides(cfg, {"model.backbone.name": "swin_large"})


def convnext_large_coco_panoptic() -> HIPIEConfig:
    """ConvNeXt-L backbone variant (reference hipie/backbone/convnext.py)."""
    cfg = r50_coco_panoptic()
    return apply_overrides(cfg, {"model.backbone.name": "convnext_large"})


def r50_refcoco() -> HIPIEConfig:
    """RefCOCO grounding eval (task='grounding' at call time)."""
    return r50_coco_panoptic()


def open_vocab_eval(num_text_tokens: int = 1536) -> HIPIEConfig:
    """Open-vocab semseg eval: long label-set prompts, CLIP ensemble, max-pool
    token->class scores (configs/eval/*pascal.yaml)."""
    cfg = r50_coco_panoptic()
    return apply_overrides(cfg, {
        "model.text.max_query_len": num_text_tokens,
        "model.clip.enabled": True,
        "model.clip.alpha": 0.35,
        "model.clip.beta": 0.45,
        "test.max_pool_tokens": True,
        "test.bg_cls_agnostic": True,
        "test.use_bg_for_pano": False,
    })


def parts_finetune() -> HIPIEConfig:
    """Pascal-Parts hierarchical config (r50_parts.yaml: PART_MODE on)."""
    cfg = r50_coco_panoptic()
    return apply_overrides(cfg, {"model.part_mode": True})
