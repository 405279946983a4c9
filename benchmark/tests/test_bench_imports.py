"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program either (top-level module names, compared
whole: `amira_tpu_torch` begins with `amira_tpu`)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH

CHECK = """
import json, sys
sys.path.insert(0, {bench!r}); sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = CHECK.format(bench=str(BENCH), root=str(BENCH.parent), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True, timeout=120)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(
        "import run, readings, spec, generate, reference, score, bounds, devtrace, faults, phases\n"
        "for m in spec.benchmark()['per_layer'] + spec.benchmark()['end_to_end']: spec.reader(m['name'])\n"
        "import amira_tpu_torch.pipeline, amira_tpu_torch.__main__"
    )
    assert not names & {"jax", "jaxlib", "flax", "amira_tpu"}
    assert "amira_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import reference, score, generate, bounds")
    assert not names & {"jax", "jaxlib", "flax", "amira_tpu", "amira_tpu_torch", "torch"}
