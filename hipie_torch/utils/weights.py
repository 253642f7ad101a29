"""Carry weights across from the JAX package.

``hipie_torch.utils.export.export_hipie_checkpoint`` (numpy only, the port's
copy of the JAX package's) turns a hipie_tpu parameter tree, given as numpy
arrays, into a torch-layout state_dict under the reference's names, which is
exactly the port's module tree, so a strict load is the whole bridge;
``export_lang_layers`` adds the in-encoder BERT layers that it leaves out.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from hipie_torch.utils.export import export_hipie_checkpoint, export_lang_layers


_KEEP_INIT = ("sampling_offsets.bias", "attention_weights.bias")


@torch.no_grad()
def random_init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Redraw the random parameters of ``model`` from ``generator``.

    Every parameter of two or more dims becomes N(0, 1/fan_in) (fan_in = the
    size of one output slice) and every other ``*.bias`` N(0, 0.02^2). The rest
    (norms, layer scales, VLAlign's bias0 and log_scale, MSDeformAttn's radial
    offset grid) keep their constant module initialisation, so the result
    depends on the generator's seed alone.
    """
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith(".bias") and not name.endswith(_KEEP_INIT):
            p.normal_(0.0, 0.02, generator=generator)


def load_from_jax(model: torch.nn.Module, params_np: Dict[str, Any], cfg) -> None:
    """Load ``model.init(...)["params"]`` (as numpy) of the JAX HIPIEModel for config
    ``cfg`` into the port's HIPIEModel; raises on any missing or unexpected key."""
    sd = {**export_hipie_checkpoint(params_np, cfg), **export_lang_layers(params_np, cfg)}
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
