"""What every cell shares: the checkout's paths, BENCHMARK.json and the files
it names, configurations, weights from the seed, the class map, the clock and
the import guard.

Nothing here imports the program at module level: a module of the program is
imported inside the function that needs it, so that the guard and the tests
can load this file alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = BENCH.parent                                     # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "hipie_tpu")      # top-level names, compared whole
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_HBM_BYTES = 3.35e12        # HBM3, bytes/s


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    per-layer metrics resolved from their files."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if mine(m) and m["moves"] in reported]
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())["limits"]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer,
                {k: float(v["limit"]) for k, v in limits.items()})


def load_reader(metric: str):
    """The reader of a per-layer metric: ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(config: Dict[str, Any], **extra):
    """The program's HIPIEConfig: its preset, the file's overrides, ``extra``."""
    from hipie_torch import presets
    from hipie_torch.config import apply_overrides

    return apply_overrides(getattr(presets, config["preset"])(),
                           {**config.get("overrides", {}), **extra})


def reference_config(config: Dict[str, Any], **extra):
    """The same configuration built by the reference's own copy, in f32."""
    from hipie_plain import presets
    from hipie_plain.config import apply_overrides

    return apply_overrides(getattr(presets, config["preset"])(),
                           {**config.get("overrides", {}), **extra,
                            "model.dtype": "float32"})


_KEEP_INIT = ("sampling_offsets.bias", "attention_weights.bias")
_CHUNK = 1 << 28


def weight_plan(named_shapes):
    """[(name, shape, kind)] in order: "w" for a parameter of two or more dims
    (N(0, 1/fan_in), fan_in the size of one output slice), "b" for any other
    ``*.bias`` but MSDA's offset grid and weight biases (N(0, 0.02^2)); the rest
    (norms, layer scales, the offset grid) keep their module initialisation."""
    out = []
    for name, shape in named_shapes:
        if len(shape) >= 2:
            out.append((name, tuple(shape), "w"))
        elif name.endswith(".bias") and not name.endswith(_KEEP_INIT):
            out.append((name, tuple(shape), "b"))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw_weights(named_shapes, seed: int, device, dtype):
    """{name: tensor} of the drawn parameters, made on ``device`` in ``dtype``
    from one torch.Generator seeded with ``seed``: one normal draw for all
    weights and one for all biases (in pieces of 2^28), each cut into the
    parameters in order and scaled. The same names, shapes, seed, device and
    dtype give the same tensors, bit for bit."""
    import torch

    plan = weight_plan(named_shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {}
    for kind in ("w", "b"):
        items = [(n, s) for n, s, k in plan if k == kind]
        total = sum(_numel(s) for _, s in items)
        pieces, left = [], total
        while left > 0:
            n = min(left, _CHUNK)
            pieces.append(torch.randn(n, generator=gen, device=device, dtype=dtype))
            left -= n
        flat = torch.cat(pieces) if len(pieces) > 1 else (pieces[0] if pieces else None)
        off = 0
        for name, shape in items:
            n = _numel(shape)
            scale = _numel(shape[1:]) ** -0.5 if kind == "w" else 0.02
            out[name] = flat[off:off + n].view(shape) * scale
            off += n
    return out


def fill_weights_(model, seed: int, dtype) -> None:
    """Draw ``model``'s weights from the seed (``draw_weights`` in ``dtype``)
    and copy them in; the parameters keep their own dtype."""
    import torch

    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    drawn = draw_weights([(n, tuple(p.shape)) for n, p in params.items()], seed, dev, dtype)
    with torch.no_grad():
        for name, t in drawn.items():
            params[name].copy_(t)
    del drawn


def weight_seed(config: Dict[str, Any]) -> int:
    """The seed of the configuration's weights: the file's ``weights_seed``, the
    same in every run. A deployment serves and trains one model; the run's
    ``--seed`` draws its traffic (images, batches, the step's random draws).
    Random weights set how many of the 900 queries survive NMS (503-577 an
    image under one draw, 895-900 under another), so weights that moved with
    the run's seed would move the work it asks for."""
    return int(config["weights_seed"])


def class_maps(maps_mod, n_classes: int, n_things: int, L: int, dev):
    """The class map over a synthetic prompt: class c owns token 1 + c % (L - 2);
    the first ``n_things`` classes are things. ``maps_mod`` is the program's or
    the reference's postprocess module (its ClassMaps)."""
    import torch

    mw = torch.zeros(n_classes, L)
    idx = torch.arange(n_classes)
    mw[idx, 1 + idx % (L - 2)] = 1.0
    return maps_mod.ClassMaps(mw.to(dev), (mw > 0).to(dev),
                              torch.arange(n_classes, device=dev) < n_things)


def prompt_ids(L: int, vocab: int):
    """The synthetic prompt's token ids (the repository has no BERT vocabulary)."""
    import torch

    return ((torch.arange(L) % 1000 + 999) % vocab)[None]


def two_stage_ks(mc):
    """The two-stage top-k sizes whose choices ``harness.choices`` records."""
    return {mc.transformer.two_stage_num_proposals, mc.maskdino.num_queries}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def log_marks(marks, t0: float) -> None:
    """Set-up's phases, in seconds: from the process's start to the first mark
    (imports, the card's context), then between marks."""
    parts = [f"before {marks[0][0]} {marks[0][1] - t0:.2f}"]
    parts += [f"{n} {t - p:.2f}" for (_, p), (n, t) in zip(marks, marks[1:])]
    log("[setup] " + "; ".join(parts))


def usage(since=None):
    """The process's CPU seconds and context switches, or their change since
    an earlier reading (as text)."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    now = (r.ru_utime, r.ru_stime, r.ru_nvcsw, r.ru_nivcsw)
    if since is None:
        return now
    d = [a - b for a, b in zip(now, since)]
    return (f"window CPU user {d[0]:.2f} s, system {d[1]:.2f} s, voluntary switches {d[2]}, "
            f"involuntary {d[3]}")


def set_cache_dirs() -> None:
    """Kernel caches a library may keep go inside the checkout, at fixed paths
    (the program's own kernels build into hipie_torch/_build/<hash>/)."""
    cache = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = sorted(set(limits) - set(values))
    if missing:
        raise AssertionError(f"no reading of {missing}")
    return [Check(k, float(values[k]), limits[k]) for k in limits]
