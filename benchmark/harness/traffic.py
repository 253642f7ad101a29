"""The one traffic generator. A mix is a data file, ``benchmark/traffic/<mix>.json``,
whose ``kind`` picks the part of this file that reads it:

* ``serve``: a pool of ``pool`` distinct uint8 images of ``image`` (H, W, 3),
  drawn from the seed into pinned host memory; request k takes the ``batch``
  images that follow image ``batch * k`` in the pool, in a closed loop.
* ``train``: a pool of ``pool`` training batches made on the device from the
  seed (the synthetic batches of the port's ``train/synthetic.py``, redrawn
  here in a few tensor calls): ``batch`` canvases of ``image`` x ``image``,
  image b valid up to ``widths[b]`` columns, ``slots`` GT slots, of which image
  j of the pool has ``valid_counts[j % len]`` valid; slot k is a thing where
  ``k % thing_period < thing_slots``, a stuff class otherwise. So every seed
  gives every step the same number of valid, thing and stuff GTs; the seed
  draws only classes, boxes and pixels. Masks are rectangles at stride 4, the
  prompt the synthetic one, each of the 133 classes owning one or two tokens.

The batches are plain dicts of tensors; each side wraps them in its own types.
"""

from __future__ import annotations

from typing import Any, Dict, List


def _gen(seed: int, salt: int, device):
    import torch

    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + salt) % (1 << 62))


def serve_pool(mix: Dict[str, Any], seed: int, pin: bool = True):
    """(pool, H, W) images uint8 (pinned where ``pin``)."""
    import torch

    h, w = mix["image"]
    imgs = torch.randint(0, 256, (mix["pool"], h, w, 3), dtype=torch.uint8,
                         generator=_gen(seed, 1, "cpu"))
    return imgs.pin_memory() if pin else imgs


def serve_request_images(mix: Dict[str, Any], k: int) -> List[int]:
    """The pool indices of request k."""
    b, n = mix["batch"], mix["pool"]
    return [(b * k + i) % n for i in range(b)]


def valid_counts(mix: Dict[str, Any]) -> List[List[int]]:
    """[batch][image] valid GT counts of the pool: the same for every seed."""
    counts, b = mix["valid_counts"], mix["batch"]
    return [[counts[(p * b + i) % len(counts)] for i in range(b)] for p in range(mix["pool"])]


def train_pool(mix: Dict[str, Any], seed: int, text_len: int, vocab: int, num_classes: int,
               device) -> List[Dict[str, Any]]:
    """The pool of training batches, on ``device``."""
    import torch

    g = _gen(seed, 3, device)
    n_cls, n_things = mix["classes"], mix["things"]
    img, b, slots = mix["image"], mix["batch"], mix["slots"]
    hm = img // 4
    widths = mix["widths"]
    L = text_len
    # class c owns tokens [1 + (2c) % (L - 3), +1 + c % 2), as train/synthetic.py
    cls = torch.arange(n_cls, device=device)
    start, ntok = 1 + (2 * cls) % (L - 3), 1 + cls % 2
    tok = torch.arange(L, device=device)
    span = ((tok[None] >= start[:, None]) & (tok[None] < (start + ntok)[:, None])).float()
    span = span / ntok[:, None].float()                                   # (C, L)
    k = torch.arange(slots, device=device)
    thing_slot = (k % mix["thing_period"]) < mix["thing_slots"]
    ys = torch.arange(hm, device=device, dtype=torch.float32)
    wm = torch.tensor([w // 4 for w in widths], device=device, dtype=torch.float32)
    counts = torch.tensor(valid_counts(mix), device=device)
    ids = prompt_ids_on(L, vocab, device).expand(b, L)
    out = []
    for p in range(mix["pool"]):
        valid = k[None] < counts[p][:, None]                              # (B, S)
        u = torch.rand((b, slots, 4), generator=g, device=device)
        c_thing = torch.randint(0, n_things, (b, slots), generator=g, device=device)
        c_stuff = torch.randint(n_things, n_cls, (b, slots), generator=g, device=device)
        c = torch.where(thing_slot[None], c_thing, c_stuff)
        y0 = (u[..., 0] * (hm - 8)).floor()
        x0 = (u[..., 1] * (wm[:, None] - 8)).floor()
        y1 = y0 + 8 + (u[..., 2] * (hm - y0 - 7)).floor()
        x1 = x0 + 8 + (u[..., 3] * (wm[:, None] - x0 - 7)).floor()
        inside = ((ys[:, None] >= y0[..., None, None]) & (ys[:, None] < y1[..., None, None])
                  & (ys[None, :] >= x0[..., None, None]) & (ys[None, :] < x1[..., None, None]))
        masks = (inside & valid[..., None, None]).float()                  # (B, S, hm, hm)
        xyxy = torch.stack([x0, y0, x1, y1], -1) / hm
        cxcywh = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]],
                           -1)
        boxes = torch.where(valid[..., None], cxcywh, torch.zeros_like(cxcywh))
        labels = torch.where(valid, c % num_classes, torch.zeros_like(c))
        pm = torch.where(valid[..., None], span[c], torch.zeros(1, device=device))
        is_thing = valid & (c < n_things)
        images = torch.randint(0, 256, (b, img, img, 3), generator=g, device=device,
                               dtype=torch.uint8)
        cols = torch.arange(img, device=device)
        pad = (cols[None, None, :] >= torch.tensor(widths, device=device)[:, None, None]
               ).expand(b, img, img).contiguous()
        images = images.masked_fill(pad[..., None], 0)
        out.append({"images": images, "pad_mask": pad, "input_ids": ids.clone(),
                    "lang_mask": torch.ones(b, L, dtype=torch.long, device=device),
                    "image_sizes": torch.tensor([[img, w] for w in widths], device=device),
                    "labels": labels, "boxes": boxes, "masks": masks, "positive_map": pm,
                    "is_thing": is_thing, "valid": valid})
    return out


def prompt_ids_on(L: int, vocab: int, device):
    import torch

    return ((torch.arange(L, device=device) % 1000 + 999) % vocab)[None]


def work_counts(mix: Dict[str, Any], batch: Dict[str, Any]) -> Dict[str, Any]:
    """What a training batch asks of the step: valid, thing and stuff GTs by image."""
    v = batch["valid"]
    return {"valid": v.sum(1).tolist(), "things": (v & batch["is_thing"]).sum(1).tolist(),
            "stuff": (v & ~batch["is_thing"]).sum(1).tolist(),
            "shape": list(batch["images"].shape)}
