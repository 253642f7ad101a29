"""High-level inference API: image + text prompts -> instance/panoptic/semantic
masks, or the instance a referring expression names.

Counterpart of hipie_tpu/predictor.py (reference projects/HIPIE/predictor.py
and demo_lib/part_segm_demo.py). The host tokenizes, builds the prompt's class
maps (``hipie_torch.data.prompts``, numpy) and resizes and pads the image;
the model, ``hipie_inference`` and the rescale of masks and maps to the
original resolution run on the predictor's device. Results are numpy, as the
JAX predictor gives them.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hipie_torch.config import HIPIEConfig
from hipie_torch.data.prompts import PromptSpec, build_prompt_spec, grounding_prompt_spec
from hipie_torch.data.transforms import pad_to_bucket, resize_bilinear, resize_shortest_edge
from hipie_torch.models.hipie import HIPIEModel, InferenceResult, hipie_inference
from hipie_torch.models.text.tokenizer import WordPieceTokenizer
from hipie_torch.parallel.mesh import model_size
from hipie_torch.parallel.tensor import shard_module_, tp_plan


def parse_def_string(defs: Sequence[str]) -> Tuple[List[str], List[bool]]:
    """'name' or 'name:stuff' entries -> (names, is_thing), as part_segm_demo.py."""
    names, is_thing = [], []
    for d in defs:
        name, _, kind = d.partition(":")
        names.append(name.strip())
        is_thing.append(kind.strip().lower() != "stuff")
    return names, is_thing


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(H, W) integer map -> (h, w); cv2.INTER_NEAREST's floor index mapping."""
    return F.interpolate(x[None, None].float(), size=size, mode="nearest")[0, 0].to(x.dtype)


class HIPIEPredictor:
    """Runs ``model`` (a hipie_torch HIPIEModel, in its own dtype) on one image
    padded to ``bucket``. The model is moved to ``device``, the card unless the
    caller passes ``device="cpu"``; without a card the default raises.
    With ``model.bg_query_from_lang``, a detection call adds one bg query per
    stuff label, from that label's token weights (reference
    prepare_bg_queries_lan, hipie_img.py:336).

    With MODEL.CLIP.ENABLED, detection calls ensemble MaskCLIP scores into the
    results through ``clip_scorer`` (``postprocess_clip.CLIPScorer``: the
    frozen CLIP towers and the per-label-set text-embedding cache); without
    one, random-init towers with the toy CLIP tokenizer are built, and that is
    printed.

    Under a model axis (``create_mesh(tp=...)``) a whole model is cut to this
    rank's shard (``shard_module_``); the model group's ranks then call the
    predictor together, on the same image."""

    def __init__(self, cfg: HIPIEConfig, model: HIPIEModel, tokenizer: WordPieceTokenizer,
                 bucket: Tuple[int, int] = (800, 1216), device="cuda", clip_scorer=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HIPIEPredictor: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        self.cfg = cfg
        self.model = model.to(self.device)
        if model_size() > 1 and not tp_plan(self.model):
            shard_module_(self.model)       # under a model axis: this rank's shard
        self.tok = tokenizer
        self.bucket = bucket
        self.clip_scorer = clip_scorer
        if cfg.model.clip.enabled and clip_scorer is None:
            from hipie_torch.models.postprocess_clip import CLIPScorer
            from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer

            print("[predictor] MODEL.CLIP.ENABLED with no CLIPScorer given: building "
                  "RANDOM-INIT CLIP towers (pass a clip_scorer built from open_clip weights "
                  "for real open-vocab scores)")
            self.clip_scorer = CLIPScorer(cfg.model.clip, CLIPTokenizer.toy(), device=self.device)

    def _run(self, spec: PromptSpec, img: np.ndarray, task: str,
             has_thing: bool) -> Tuple[InferenceResult, Tuple[int, int]]:
        """Resize, pad, model and ``hipie_inference``; the result stays on the device."""
        cfg, dev = self.cfg, self.device
        resized, _ = resize_shortest_edge(img, cfg.data.min_size_test, cfg.data.max_size_test)
        h, w = resized.shape[:2]
        padded, pad_mask = pad_to_bucket(resized, self.bucket)
        to_dev = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        maps = spec.class_maps(dev)
        clip_fn = clip_overlap = None
        if cfg.model.clip.enabled and task == "detection":
            # synonym groups: a name with commas lists synonyms (hipie_img.py:818)
            clip_fn, clip_overlap = self.clip_scorer.make_clip_fn(
                [n.split(",") for n in spec.class_names])
        n_bg_lang, bg_lang_weights = 0, None
        if cfg.model.bg_query_from_lang and task == "detection":
            stuff = ~np.asarray(spec.is_thing, bool)
            n_bg_lang = int(stuff.sum())
            if n_bg_lang:
                bg_lang_weights = to_dev(np.asarray(spec.mean_weights)[stuff])
        with torch.inference_mode():
            pad = to_dev(pad_mask[None])
            images = to_dev(padded[None])
            out = self.model(images, pad, to_dev(spec.input_ids[None]).long(),
                             to_dev(spec.attention_mask[None]), torch.tensor([[h, w]], device=dev),
                             task=task, bg_lang_weights=bg_lang_weights)
            # CLIP sees the padded canvas in [0, 1]
            images01 = None if clip_fn is None else (images.float() / 255.0).clamp(0.0, 1.0)
            res = hipie_inference(out, maps, cfg.test, cfg.model, task=task,
                                  has_thing=has_thing, pad_mask_s4=pad[0][::4, ::4],
                                  clip_fn=clip_fn, clip_overlap=clip_overlap, images01=images01,
                                  n_bg_lang=n_bg_lang)
        return res, (h, w)

    @staticmethod
    def _rescale_masks(mask_logits: torch.Tensor, valid_hw, out_hw) -> torch.Tensor:
        """Stride-4 logits -> bool masks at the original resolution (reference
        segmentation_postprocess: bilinear x4, crop to the valid region, resize)."""
        (h, w), (oh, ow) = valid_hw, out_hw
        if mask_logits.shape[0] == 0:
            return torch.zeros((0, oh, ow), dtype=torch.bool, device=mask_logits.device)
        up = resize_bilinear(mask_logits, (mask_logits.shape[1] * 4, mask_logits.shape[2] * 4))
        return resize_bilinear(up[:, :h, :w], (oh, ow)) > 0

    def __call__(self, image: np.ndarray, task: str = "detection",
                 expressions: Optional[str] = None,
                 test_categories: Optional[Sequence[str]] = None,
                 test_is_thing: Optional[Sequence[bool]] = None,
                 score_thresh: float = 0.5) -> Dict[str, Any]:
        """image: (H, W, 3) uint8 RGB. Returns a dict with instances (boxes xyxy in
        original pixels, scores, classes, masks, class_names) and, for detection,
        panoptic_seg (map, segments) and sem_seg."""
        oh, ow = image.shape[:2]
        if task == "grounding":
            spec = grounding_prompt_spec(expressions or "", self.tok, self.cfg.data.max_text_len)
            has_thing = True
        elif task == "detection":
            if test_categories is None:
                raise ValueError("detection needs test_categories")
            if test_is_thing is None:
                test_categories, test_is_thing = parse_def_string(test_categories)
            spec = build_prompt_spec(test_categories, test_is_thing, self.tok,
                                     self.cfg.data.max_text_len)
            has_thing = any(test_is_thing)
        else:
            raise ValueError(f"task must be 'detection' or 'grounding', got {task!r}")

        res, (h, w) = self._run(spec, image, task, has_thing)
        with torch.inference_mode():
            keep = (res.scores > score_thresh if task == "detection"
                    else torch.ones_like(res.scores, dtype=torch.bool))
            # boxes are normalised to the valid region; scale to original pixels
            f64 = dict(dtype=torch.float64, device=self.device)
            boxes = (res.boxes[keep].double() * torch.tensor([w, h, w, h], **f64)
                     * torch.tensor([ow / w, oh / h, ow / w, oh / h], **f64))
            masks = self._rescale_masks(res.mask_logits[keep], (h, w), (oh, ow))
            out: Dict[str, Any] = {"instances": {
                "boxes": boxes.cpu().numpy(), "scores": res.scores[keep].cpu().numpy(),
                "classes": res.classes[keep].cpu().numpy(), "masks": masks.cpu().numpy(),
                "class_names": spec.class_names}}
            if res.panoptic is not None:
                # crop the valid stride-4 region of the padded canvas, then resize
                h4, w4 = -(-h // 4), -(-w // 4)
                pan = resize_nearest(res.panoptic[:h4, :w4], (oh, ow)).cpu().numpy()
                valid = res.segment_valid.cpu().numpy()
                seg_ids = np.cumsum(valid.astype(np.int64))
                classes = res.segment_classes.cpu().numpy()
                isthing = res.segment_isthing.cpu().numpy()
                out["panoptic_seg"] = (pan, [
                    {"id": int(seg_ids[i]), "category_id": int(classes[i]),
                     "isthing": bool(isthing[i])} for i in np.flatnonzero(valid)])
                sem = res.sem_seg[:, :h4, :w4].argmax(0).int()
                out["sem_seg"] = resize_nearest(sem, (oh, ow)).cpu().numpy()
        return out


class PartSegmDemo:
    """Hierarchical part segmentation: a second pass with a parts label set,
    intersected with the instance masks (part_segm_demo.py:191-354)."""

    def __init__(self, predictor: HIPIEPredictor, part_labels: Sequence[str]):
        self.predictor = predictor
        self.part_labels = list(part_labels)

    def forward_panoptic(self, image: np.ndarray, things_labels: Sequence[str],
                         stuff_labels: Sequence[str], do_part: bool = False):
        cats = list(things_labels) + [f"{s}:stuff" for s in stuff_labels]
        result = self.predictor(image, task="detection", test_categories=cats)
        if do_part:
            result["parts"] = self.forward_parts(image, result)
        return result

    def forward_parts(self, image: np.ndarray, panoptic_result: Dict[str, Any]):
        """Second pass with the parts label set -> per-instance part maps."""
        part_sem = self._part_sem_seg(image)
        maps = [np.where(m, part_sem + 1, 0) for m in panoptic_result["instances"]["masks"]]
        return {"part_sem_seg": part_sem, "instance_part_maps": maps,
                "part_labels": self.part_labels}

    def forward_reference(self, image: np.ndarray, expression: str,
                          part: Optional[str] = None):
        res = self.predictor(image, task="grounding", expressions=expression, score_thresh=0.0)
        if part is not None and len(res["instances"]["masks"]):
            part_sem = self._part_sem_seg(image)
            if part in self.part_labels:
                pid = self.part_labels.index(part)
                res["part_mask"] = res["instances"]["masks"][0] & (part_sem == pid)
        return res

    def _part_sem_seg(self, image: np.ndarray) -> np.ndarray:
        return self.predictor(image, task="detection", test_categories=self.part_labels,
                              test_is_thing=[False] * len(self.part_labels))["sem_seg"]


class AsyncPredictor:
    """Pipelined predictor: worker threads each run a whole predictor call, so
    one image's host pre- and post-processing overlaps another's device work
    (reference predictor.py AsyncPredictor). Results come in submission order.

        ap = AsyncPredictor(predictor, workers=2)
        results = list(ap.map(images, test_categories=cats))
        ap.shutdown()
    """

    def __init__(self, predictor: HIPIEPredictor, workers: int = 2):
        self.predictor = predictor
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def submit(self, image: np.ndarray, **kwargs) -> concurrent.futures.Future:
        return self.pool.submit(self.predictor, image, **kwargs)

    def map(self, images: Sequence[np.ndarray], **kwargs):
        """Ordered results for a sequence of images (a generator)."""
        futs = [self.submit(im, **kwargs) for im in images]
        for f in futs:
            yield f.result()

    def shutdown(self):
        self.pool.shutdown(wait=True)
