"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
configuration's widths and depths shrunk (the port's ``tiny_test_config``
sizes), images of 64x64, 8 GT slots. Tests only."""

import torch

from harness import common

torch.set_num_threads(2)

TINY = {
    "model.backbone.name": "resnet_tiny", "model.text.hidden_size": 32,
    "model.text.num_layers": 2, "model.text.num_heads": 2, "model.text.intermediate_size": 64,
    "model.text.vocab_size": 128, "model.text.max_query_len": 16,
    "model.transformer.d_model": 32, "model.transformer.nhead": 2,
    "model.transformer.num_encoder_layers": 2, "model.transformer.num_decoder_layers": 2,
    "model.transformer.dim_feedforward": 64, "model.transformer.vl_hidden_dim": 64,
    "model.transformer.two_stage_num_proposals": 20, "model.transformer.num_queries": 20,
    "model.transformer.num_bg_queries": 4, "model.maskdino.hidden_dim": 32,
    "model.maskdino.num_queries": 12, "model.maskdino.dim_feedforward": 64,
    "model.maskdino.dec_layers": 2, "model.maskdino.enc_layers": 2,
    "model.maskdino.mask_dim": 32, "model.maskdino.dn_queries": 4,
    "model.mask_head.in_channels": 32, "model.mask_head.dynamic_mask_channels": 4,
    "model.dn.dn_number": 4, "model.loss.num_points": 64, "test.detections_per_image": 10,
    "solver.warmup_iters": 0}


def tiny_cell(name: str, serve_dtype: str = "float32") -> common.Cell:
    cell = common.load_cell(name)
    cell.config = dict(cell.config, overrides=TINY, serve_dtype=serve_dtype)
    mix = dict(cell.traffic)
    if mix["kind"] == "serve":
        mix.update(image=[128, 128], pool=4, sample_from_first=3, sample_requests=2,
                   warmup_requests=1)
    else:
        mix.update(image=64, widths=[64, 56], slots=8, valid_counts=[2, 6, 3, 5], pool=4)
    cell.traffic = mix
    return cell
