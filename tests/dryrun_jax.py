"""repro's dry-run references for tests/test_torch_dryrun.py, in a
subprocess of its own: 8 fake CPU devices, a (2, 2, 2) ("pod", "data",
"model") mesh of ``AxisType.Auto`` axes under ``jax.set_mesh``. For each
cell, repro's ``build_cell_program`` lowered and compiled as its
``run_cell`` does: ``compiled.memory_analysis()``'s argument and output
bytes and ``analyze_hlo(compiled.as_text())``. The cells' small shapes are
added to repro's ``SHAPES`` in this process only.

    python -m tests.dryrun_jax OUT.json CELLS   (CELLS: JSON [[arch, shape name], ...];
                                                 SHAPES: tests/test_torch_dryrun.py's)
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.dryrun import build_cell_program  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.config import SHAPES, ShapeConfig  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cells, shapes = json.loads(argv[1]), json.loads(argv[2])
    for name, (seq, batch, kind) in shapes.items():
        SHAPES[name] = ShapeConfig(name, seq, batch, kind)
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    out = {}
    for arch, shape in cells:
        fn, args = build_cell_program(get_smoke_config(arch), shape, mesh)
        with jax.set_mesh(mesh):
            compiled = fn.lower(*args).compile()
        mem = compiled.memory_analysis()
        out[f"{arch}/{shape}"] = {
            "argument_size_in_bytes": int(mem.argument_size_in_bytes),
            "output_size_in_bytes": int(mem.output_size_in_bytes),
            "hlo": analyze_hlo(compiled.as_text())}
    with open(argv[0], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
