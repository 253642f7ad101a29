"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel wrapper (``hipie_torch/ops/*.py``) adds one to its entry in
``LAUNCHES`` where it launches its kernel, and nowhere else, so a run can show
that the main path went through the kernels.
"""

LAUNCHES = {"vit_attention": 0, "ms_deform_attn": 0, "msda_reduce": 0, "ms_deform_attn_bwd": 0,
            "vit_attention_bwd": 0, "nms": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
