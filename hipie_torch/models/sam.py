"""SAM mask-refinement hook + SAM-mask labeling utilities.

Counterpart of hipie_tpu/models/sam.py (the same host code, kept in the port
so that it imports nothing of the JAX package).

Behavioral parity target: reference hipie/models/sam.py (build_sam thin wrapper —
the import is commented out upstream too), the inference hook replacing predicted
masks by SAM box-prompted masks (hipie_img.py:367-390), and the Demo-HIPIE+SAM
mask-voting labeler (demo_lib/demo_utils.py:19-47 `vote`).

SAM runs host-side as an optional dependency (mirroring the reference, where
`segment_anything` is an optional install); the hook interface below lets any
box-promptable mask model plug in.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def build_sam(checkpoint: Optional[str] = None):
    """Load segment_anything if present (reference hipie/models/sam.py:1-9)."""
    try:
        from segment_anything import SamPredictor, sam_model_registry
    except ImportError:
        return None
    sam = sam_model_registry["vit_h"](checkpoint=checkpoint)
    return SamPredictor(sam)


def refine_masks_with_sam(sam_predictor, image_rgb: np.ndarray,
                          boxes_xyxy: np.ndarray,
                          out_hw: Sequence[int]) -> Optional[np.ndarray]:
    """Replace predicted masks by SAM box-prompted masks (hipie_img.py:367-390).

    Returns (N, H, W) bool masks or None when SAM is unavailable.
    """
    if sam_predictor is None or len(boxes_xyxy) == 0:
        return None
    import torch

    sam_predictor.set_image(image_rgb)
    tb = sam_predictor.transform.apply_boxes_torch(
        torch.as_tensor(boxes_xyxy, dtype=torch.float32), image_rgb.shape[:2])
    masks, _, _ = sam_predictor.predict_torch(
        point_coords=None, point_labels=None, boxes=tb, multimask_output=False)
    masks = masks.float()
    import torch.nn.functional as F
    masks = F.interpolate(masks, tuple(out_hw), mode="area") > 0.5
    return masks[:, 0].cpu().numpy()


def vote_labels(sam_masks: Sequence[np.ndarray],
                sem_seg: np.ndarray, num_classes: int,
                min_fraction: float = 0.0) -> List[int]:
    """Label SAM masks by majority vote over a semantic map
    (demo_utils.py:19-47). Returns one class id per mask (-1 if empty)."""
    out = []
    for m in sam_masks:
        m = m.astype(bool)
        if not m.any():
            out.append(-1)
            continue
        votes = np.bincount(sem_seg[m].reshape(-1), minlength=num_classes)
        cls = int(votes.argmax())
        if votes[cls] < min_fraction * m.sum():
            cls = -1
        out.append(cls)
    return out
