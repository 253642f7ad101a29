"""The training step: CDN queries -> model forward -> fg / bg / gt and MaskDINO
criterion passes -> weighted total -> backward -> clipped AdamW update.

Counterpart of hipie_tpu/train/step.py (reference ddetrs_dn.py coco_forward,
hipie_img.py's train branch and train_net.py's optimizer wrapper). Query
layout [dn | bg_lang | bg | fg]: the fg queries are matched by simOTA or the
Hungarian auction (``loss.matcher``), the bg (stuff) queries by the auction
with mask costs, the dn slots by their fixed CDN indices. With
``model.bg_query_from_lang`` the ``num_bg_lang_queries`` language-derived slots
(``hipie_torch.train.bg_lang``) are supervised against the stuff GTs by their
fixed class assignment, in a pass that replaces the bg pass at the bg weight
(the reference runs the bg pass at weight 0, so the gradients are the same).
The passes merge with
FINAL_FG/BG/GT_WEIGHT (a zero-weight pass is skipped, as in JAX: it would only
be multiplied by 0). The encoder-proposal losses ride the gt pass. The MaskDINO
branch adds its own passes (class 4, mask 5, dice 5, box 5, GIoU 2): matching
queries, seg-DN slots and the two-stage ("interm") prediction.

Precision follows the JAX package's ``dtype="bfloat16"`` with f32 parameters:
the forward runs under ``torch.autocast`` in bf16 when the config's dtype is
bfloat16, with sampling locations, attention and class logits in f32 as the
modules cast them; every loss is computed in f32 outside autocast. A ViT
backbone's drop-path masks are drawn before the forward; ``backbone.vit_remat``
and ``transformer.remat`` checkpoint the blocks and layers (the models read
them). The step
is eager; it runs on the card unless the caller passes ``device="cpu"``. Its
parts carry torch.profiler ranges ("cdn", "forward", "crit_fg", "crit_bg" or
"crit_bg_lang", "crit_enc",
"crit_gt_dn", "crit_maskdino", "crit_maskdino_dn", "crit_maskdino_interm",
"backward", "allreduce", "optimizer"), which ``python3 -m hipie_torch.train.profile``
reads.

Data parallelism (hipie_torch/parallel/mesh.py) is the same step on every
rank over its share of the global batch, after ``init_distributed``: CDN's
group count, every loss normaliser and the batch-shaped random draws are the
global batch's (the modules ask the process group), the language-derived bg
queries pool the global batch's prompts, and ``reduce_gradients`` averages
the gradients between the backward and the optimizer ("allreduce"), so that
every rank takes the update one process takes on the global batch. Without a
process group none of this runs.

Tensor parallelism (hipie_torch/parallel/tensor.py): ``create_train_state``
cuts the model to the rank's shard of the model group; the ranks of a model
group take the same images and draws (both follow the data group). Before
the data group's average, ``reduce_model_gradients`` makes the model group's
replicated gradients one: under ``shard_tokens`` the parameters that saw only
the rank's tokens are summed over the group, the others taken from its first
rank. Clipping takes the whole model's norm.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from hipie_torch.config import HIPIEConfig
from hipie_torch.losses.criterion import (Targets, apply_weight_dict, criterion_pass,
                                          encoder_loss_pass, merge_loss_dicts)
from hipie_torch.models.dn import prepare_cdn
from hipie_torch.models.mask_head import dynamic_conv_param_sizes
from hipie_torch.parallel.mesh import gather_batch, reduce_gradients, shard_rows
from hipie_torch.parallel.tensor import reduce_model_gradients, shard_module_
from hipie_torch.train.bg_lang import prepare_bg_lang_queries
from hipie_torch.train.optimizer import GroupedAdamW
from hipie_torch.utils.rng import Keys
from hipie_torch.utils.trace import span


class TrainBatch(NamedTuple):
    images: torch.Tensor        # (B, H, W, 3)
    pad_mask: torch.Tensor      # (B, H, W) True = pad
    input_ids: torch.Tensor     # (B, L)
    lang_mask: torch.Tensor     # (B, L)
    image_sizes: torch.Tensor   # (B, 2) valid (h, w)
    targets: Targets

    def to(self, device) -> "TrainBatch":
        move = lambda x: x.to(device, non_blocking=True)
        return TrainBatch(*(move(x) for x in self[:5]), Targets(*(move(x) for x in self.targets)))


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: GroupedAdamW
    step: int = 0


# Named ranges of the step for torch.profiler (the JAX package's named scopes);
# a flag check when no profiler runs (hipie_torch/utils/trace.py).
scope = span


def _device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to train on the CPU")
    return device


def make_loss_fn(model: torch.nn.Module, cfg: HIPIEConfig, task: str = "detection"
                 ) -> Callable[[TrainBatch, Keys], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """loss_fn(batch, keys) -> (total, metrics) for a HIPIEModel built with
    ``train=True``; ``keys`` gives every random draw (hipie_torch/utils/rng.py)."""
    mc = cfg.model
    lc = mc.loss
    md_lc = dataclasses.replace(lc, class_weight=4.0, bbox_weight=5.0, giou_weight=2.0,
                                mask_weight=5.0, dice_weight=5.0)
    weight_nums, bias_nums = dynamic_conv_param_sizes(
        mc.transformer.d_model // 32, mc.mask_head.dynamic_mask_channels,
        mc.mask_head.num_dynamic_layers, mc.mask_head.use_rel_coord)
    n_bg = mc.transformer.num_bg_queries
    n_bgl = mc.transformer.num_bg_lang_queries if mc.bg_query_from_lang else 0
    n_match = mc.transformer.num_queries + n_bg + n_bgl
    max_matched = mc.max_matched_masks
    bf16 = mc.dtype == "bfloat16"
    # a ViT backbone's drop path: keep masks drawn before the forward, from the
    # key JAX gives its "dropout" stream (fold_in(rng, 7)), so that a
    # checkpointed block recomputes with the same masks
    draw_drop_masks = getattr(model.detr.detr.backbone[0].backbone, "draw_drop_masks", None)

    def loss_fn(batch: TrainBatch, keys: Keys):
        t = batch.targets
        k_dn, k_fg, k_bg, k_gt, k_md, k_bgl = keys.split(6)
        cdn = md_dn = bgl = None
        dn_kwargs = {}
        with torch.no_grad(), scope("cdn"):
            if n_bgl > 0:
                # the slots are shared by the global batch: built from its
                # targets, each rank keeps its images' weights and assignment
                bgl = prepare_bg_lang_queries(
                    k_bgl, *(gather_batch(x) for x in (t.labels, t.positive_map, t.is_thing,
                                                       t.valid, batch.lang_mask)),
                    mc.num_classes, n_bgl)
                bgl = bgl._replace(weights=shard_rows(bgl.weights, 1),
                                   assign=shard_rows(bgl.assign))
                dn_kwargs["bg_lang_weights"] = bgl.weights
            if mc.dn.enabled:
                cdn = prepare_cdn(k_dn, t.labels, t.boxes, t.valid, mc.num_classes, n_match,
                                  dn_number=mc.dn.dn_number,
                                  label_noise_ratio=mc.dn.label_noise_ratio,
                                  box_noise_scale=mc.dn.box_noise_scale)
                dn_kwargs.update(dn_labels=cdn.noised_labels, dn_valid=cdn.slot_valid,
                                 dn_refs_unact=cdn.refs_unact, self_attn_mask=cdn.attn_mask)
            if mc.maskdino.enabled and mc.dn.enabled:
                md_dn = prepare_cdn(k_dn.fold_in(7), t.labels, t.boxes, t.valid, mc.num_classes,
                                    mc.maskdino.num_queries, dn_number=mc.maskdino.dn_queries,
                                    label_noise_ratio=0.0,
                                    box_noise_scale=mc.maskdino.noise_scale)
                dn_kwargs.update(maskdino_dn_refs=md_dn.refs_unact,
                                 maskdino_dn_valid=md_dn.slot_valid,
                                 maskdino_attn_mask=md_dn.attn_mask)
        if draw_drop_masks is not None:
            drop = draw_drop_masks(keys.fold_in(7), batch.images.shape[0])
            if drop is not None:
                dn_kwargs["drop_path_masks"] = drop
        dev_type = batch.images.device.type
        amp = (torch.autocast(dev_type, dtype=torch.bfloat16) if bf16
               else contextlib.nullcontext())
        with amp, scope("forward"):
            out = model(batch.images, batch.pad_mask, batch.input_ids, batch.lang_mask,
                        batch.image_sizes, task=task, train=True, **dn_kwargs)

        pad = cdn.pad_size if cdn is not None else 0
        start_bgl = pad
        start_bg = pad + n_bgl
        start_fg = start_bg + n_bg

        def slice_layers(s, e, with_iou):
            lo = {"classes": out["outputs_class"][:, :, s:e],
                  "boxes": out["outputs_coord"][:, :, s:e],
                  "ctrl": out["ctrl_params"][:, :, s:e],
                  "refs": out["layer_refs"][:, :, s:e]}
            if with_iou and "outputs_iou" in out:
                lo["ious"] = out["outputs_iou"][:, :, s:e]
            return lo

        mask_feats = out["mask_feats"].float()
        common = dict(text_mask=batch.lang_mask, mask_feats=mask_feats,
                      image_sizes=batch.image_sizes, cfg=lc, weight_nums=weight_nums,
                      bias_nums=bias_nums, dyn_channels=mc.mask_head.dynamic_mask_channels,
                      max_matched=max_matched)
        fg_targets = t._replace(valid=t.valid & t.is_thing)
        bg_targets = t._replace(valid=t.valid & ~t.is_thing)

        passes, weights = [], []
        if lc.final_fg_weight != 0.0:
            with scope("crit_fg"):
                passes.append(criterion_pass(
                    k_fg, slice_layers(start_fg, None, True), fg_targets,
                    matcher="ota" if lc.matcher == "ota" else "hungarian", **common))
            weights.append(lc.final_fg_weight)
        if lc.final_bg_weight != 0.0:
            if bgl is not None:
                with scope("crit_bg_lang"):
                    passes.append(criterion_pass(
                        k_bg.fold_in(1), slice_layers(start_bgl, start_bg, False), bg_targets,
                        matcher="fixed", fixed_assign=bgl.assign, **common))
            else:
                with scope("crit_bg"):
                    passes.append(criterion_pass(k_bg, slice_layers(start_bg, start_fg, False),
                                                 bg_targets, matcher="hungarian", **common))
            weights.append(lc.final_bg_weight)
        # the encoder proposals' losses: the top-k feeding the decoder is
        # detached, so without them the two-stage heads get no gradient
        with scope("crit_enc"):
            enc_losses = encoder_loss_pass(out["enc_outputs_class"],
                                           out["enc_outputs_coord_unact"].float().sigmoid(), t,
                                           batch.lang_mask, lc,
                                           still_cls=mc.still_cls_for_encoder)
        if cdn is not None and lc.final_gt_weight != 0.0:
            with scope("crit_gt_dn"):
                losses_gt = criterion_pass(k_gt, slice_layers(0, pad, False), t,
                                           matcher="fixed", fixed_assign=cdn.gt_assign, **common)
            losses_gt.update(enc_losses)
            passes.append(losses_gt)
            weights.append(lc.final_gt_weight)
        else:
            passes.append(enc_losses)
            weights.append(lc.final_gt_weight or 1.0)
        merged = merge_loss_dicts(passes, weights)
        total = apply_weight_dict(merged, lc)
        metrics = {k: v for k, v in merged.items() if "_" not in k[5:]}

        if mc.maskdino.enabled and "maskdino" in out:
            md = out["maskdino"]
            md_common = dict(text_mask=batch.lang_mask, mask_feats=mask_feats,
                             image_sizes=batch.image_sizes, cfg=md_lc, weight_nums=weight_nums,
                             bias_nums=bias_nums, max_matched=max_matched,
                             pixel_feats=md["mask_features"])
            md_layers = {"classes": torch.stack(md["aux"]["classes"] + [md["pred_logits"]]),
                         "boxes": torch.stack(md["aux"]["boxes"] + [md["pred_boxes"]]),
                         "mask_embeds": torch.stack(md["aux"]["mask_embeds"]
                                                    + [md["pred_mask_embed"]])}
            md_pad = md_dn.pad_size if md_dn is not None else 0
            with scope("crit_maskdino"):
                losses_md = criterion_pass(
                    k_md, {k: v[:, :, md_pad:] for k, v in md_layers.items()}, t,
                    matcher="hungarian", **md_common)
            if md_dn is not None:
                with scope("crit_maskdino_dn"):
                    losses_dn = criterion_pass(
                        k_md.fold_in(3), {k: v[:, :, :md_pad] for k, v in md_layers.items()},
                        t, matcher="fixed", fixed_assign=md_dn.gt_assign, **md_common)
                losses_md.update({f"{k}_dn": v for k, v in losses_dn.items()})
            interm = md["interm_outputs"]
            with scope("crit_maskdino_interm"):
                losses_interm = criterion_pass(
                    k_md.fold_in(1), {"classes": interm["pred_logits"][None],
                                      "boxes": interm["pred_boxes"][None],
                                      "mask_embeds": interm["pred_mask_embed"][None]},
                    t, matcher="hungarian", **md_common)
            losses_md.update({f"{k}_interm": v for k, v in losses_interm.items()})
            total = total + apply_weight_dict(losses_md, md_lc)
            metrics.update({f"{k}_maskdino": v for k, v in losses_md.items()
                            if "_" not in k[5:]})
        metrics["total_loss"] = total
        return total, metrics

    return loss_fn


def create_train_state(cfg: HIPIEConfig, seed: Optional[int] = None, device="cuda",
                       msda_method: str = "fused", model: Optional[torch.nn.Module] = None
                       ) -> TrainState:
    """A HIPIEModel built for training (``train=True``) on ``device`` with
    random weights from a ``torch.Generator`` seeded with ``seed`` (default
    ``cfg.seed``), f32 master weights, and its optimizer. Pass ``model`` to
    train one that exists (weights loaded from the JAX package, for example).
    Under a model axis (``create_mesh(tp=...)``) the model is cut to this
    rank's shard (``shard_module_``) before the optimizer takes it."""
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.utils.weights import random_init_

    dev = _device_of(device)
    if model is None:
        with torch.device(dev):
            model = HIPIEModel(cfg.model, msda_method=msda_method, train=True)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed if seed is None else seed)
        random_init_(model, gen)
    model = model.to(dev, torch.float32).train()
    shard_module_(model)
    return TrainState(model, GroupedAdamW(cfg.solver, model), 0)


def make_train_step(cfg: HIPIEConfig, state: TrainState, task: str = "detection",
                    device="cuda"):
    """train_step(state, batch, keys) -> (state, metrics): one loss, backward and
    optimizer update on ``device`` (the card unless the caller passes
    device="cpu"; without a card the default raises). The state is updated in
    place and returned; metrics stay on the device."""
    dev = _device_of(device)
    loss_fn = make_loss_fn(state.model, cfg, task)

    def train_step(state: TrainState, batch: TrainBatch, keys: Keys):
        batch = batch.to(dev)
        state.optimizer.zero_grad()
        total, metrics = loss_fn(batch, keys)
        with scope("backward"):
            total.backward()
        with scope("allreduce"):
            reduce_model_gradients(state.model, state.optimizer.params,
                                   cfg.model.transformer.shard_tokens)
            reduce_gradients(state.optimizer.params)
        with scope("optimizer"):
            norm = state.optimizer.step()
        if norm is not None:
            metrics["grad_norm"] = norm
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    return train_step
