"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program."""

import subprocess
import sys

from harness import common

PROBE = """
import runpy, sys
sys.path[:0] = [{bench!r}, {ref!r}, {root!r}]
import harness.main, harness.serve, harness.train, harness.trace, harness.lowp
{extra}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "hipie_tpu"))
print("FORBIDDEN", bad)
print("PROGRAM", sorted(m for m in sys.modules if m.split(".")[0] == "hipie_torch"))
"""


def _probe(extra: str):
    code = PROBE.format(bench=str(common.BENCH), ref=str(common.BENCH / "reference"),
                        root=str(common.ROOT), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if " " in line)
    return eval(lines["FORBIDDEN"]), eval(lines["PROGRAM"])


def test_the_harness_and_the_port_load_no_jax():
    bad, prog = _probe("import hipie_torch.models.hipie, hipie_torch.train.step\n"
                       "import hipie_plain.models.hipie, hipie_plain.train.step\n"
                       "for m in __import__('os').listdir({mdir!r}):\n"
                       "    harness.common.load_reader(m[:-3]) if m.endswith('.py') else None"
                       .format(mdir=str(common.BENCH / "metrics")))
    assert bad == []
    assert prog


def test_the_reference_loads_nothing_of_the_program():
    bad, prog = _probe("import hipie_plain.models.hipie, hipie_plain.train.step, "
                       "hipie_plain.presets, hipie_plain.utils.rng")
    assert bad == [] and prog == []


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload",
                          "vith_serve_coco", "--seed", "3000000123", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(common.ROOT), env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
