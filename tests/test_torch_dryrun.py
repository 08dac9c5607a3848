"""The port's dry run (``launch/dryrun.py``) and cost analysis
(``launch/cost_analysis.py``) against repro's ``launch/dryrun.py`` and
``launch/hlo_analysis.py``, on the CPU:

  * for a train, a prefill and a decode cell of the dense, moe (MLA), ssm
    and audio smoke configs on a (2, 2, 2) mesh, the bytes of the rank's
    arguments the program reads equal repro's
    ``compiled.memory_analysis()`` exactly, the bytes it holds equal the
    blocks of every parameter and input by the specs, and its
    ``dot_flops`` are within 5% of repro's ``analyze_hlo`` (repro's side in
    ``tests/dryrun_jax.py``: 8 fake devices, ``AxisType.Auto`` axes);
  * the collectives of one cell equal a hand count of the port's own;
  * llama3.2-1b ``train_4k`` on the 16 x 16 production mesh runs through
    the CLI in seconds and allocates no tensor memory;
  * ``roofline_terms`` runs on the H100's constants, none of the TPU's.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from tests.test_torch_distributed import REPO  # noqa: E402

TINY = {"train_tiny": (32, 8, "train"), "prefill_tiny": (32, 8, "prefill"),
        "decode_tiny": (32, 8, "decode")}  # (seq, global batch, kind)
ARCHS = ("llama3.2-1b", "deepseek-v3-671b", "rwkv6-7b", "whisper-large-v3")
CELLS = [(a, s) for a in ARCHS for s in TINY]
FLOP_GAP = 0.05
JAX_LIMIT_S = 180.0


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """repro's memory analysis and analyze_hlo of every cell (a subprocess)."""
    out = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tests.dryrun_jax", str(out),
                             json.dumps(CELLS), json.dumps(TINY)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, out
    if proc.poll() is None:
        proc.kill()


def _held_bytes(cfg, shape_name: str, mesh) -> int:
    """The rank's blocks of every parameter and input of a serving cell, by
    the specs: those the program never reads included."""
    from repro_torch.launch.mesh import mesh_dp_size
    from repro_torch.launch.sharding import local_shape
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import dtype_of
    from repro_torch.training.train_loop import mesh_sharding

    def size(shape, spec, dtype):
        return math.prod(local_shape(shape, spec, mesh)) * dtype.itemsize

    specs = mesh_sharding(cfg, mesh).specs
    n = sum(size(p.shape, specs[k], p.dtype)
            for k, p in tfm.Transformer(cfg, torch.device("meta")).named_parameters())
    shape = SHAPES[shape_name]
    b, dp = shape.global_batch, mesh_dp_size(mesh)
    rows = b // dp if b % dp == 0 and b >= dp else b
    if shape.kind == "prefill":
        n += rows * shape.seq_len * 4
        if cfg.family in ("vlm", "audio"):
            n += rows * cfg.n_frontend_tokens * cfg.d_model * dtype_of(cfg).itemsize
        return n
    cspecs = tfm.mesh_cache_specs(cfg, mesh, b, shape.seq_len)
    n += rows * 4 + 4  # the tokens, the position
    return n + sum(size(t.shape, cspecs[g][k], t.dtype)
                   for g, tree in tfm.cache_shape(cfg, b, shape.seq_len).items()
                   for k, t in tree.items())


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's records of every cell on a dry (2, 2, 2) mesh (this
    process rank 0 of a fake world of 8, closed at the end), each with
    ``held``: ``_held_bytes`` of its serving cells."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import evaluate_cell
    from repro_torch.launch.mesh import make_mesh

    saved = dict(SHAPES)
    SHAPES.update({n: ShapeConfig(n, *v) for n, v in TINY.items()})
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="meta", dry=True)
    try:
        records = {}
        for a, s in CELLS:
            records[(a, s)] = evaluate_cell(get_smoke_config(a), s, mesh)
            if TINY[s][2] != "train":
                records[(a, s)]["held"] = _held_bytes(get_smoke_config(a), s, mesh)
        yield records
    finally:
        dist.destroy_process_group()
        SHAPES.clear()
        SHAPES.update(saved)


@pytest.fixture(scope="module")
def repro_records(jax_ref, port):
    proc, out = jax_ref
    try:
        log, _ = proc.communicate(timeout=JAX_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"tests.dryrun_jax did not end within {JAX_LIMIT_S} s")
    assert proc.returncode == 0, log.decode()[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_memory_and_dot_flops_match_repro(port, repro_records, arch, shape):
    """The bytes of the arguments the program reads exactly repro's; the
    bytes the rank holds those of the train step's reads (it reads every
    leaf), a serving cell's its blocks of every parameter and input;
    dot_flops within 5% of repro's (the gaps are PERF.md's: GSPMD computes
    rwkv6's token-shift LoRA mixes on half of d and MLA's prefill latent
    products on its shards); the run allocated nothing."""
    got, want = port[(arch, shape)], repro_records[f"{arch}/{shape}"]
    mem = got["memory"]
    assert mem["read_argument_bytes"] == want["argument_size_in_bytes"]
    assert mem["argument_size_in_bytes"] == got.get("held", mem["read_argument_bytes"])
    if (arch, shape) == ("whisper-large-v3", "decode_tiny"):  # holds its encoder, unread
        assert mem["argument_size_in_bytes"] > mem["read_argument_bytes"]
    ratio = got["counts"]["dot_flops"] / want["hlo"]["dot_flops"]
    assert abs(ratio - 1.0) <= FLOP_GAP, ratio
    assert got["counts"]["allocated_bytes"] == 0


def test_collectives_match_a_hand_count(port):
    """llama3.2-1b's smoke prefill on (2, 2, 2): the 8 rows split 2 a
    data-parallel rank, 4 heads / 2 KV heads, d_ff 256 and vocab 512 split
    over a model axis of 2. The port all-reduces the vocab-parallel
    embedding's rows, and per layer the attention's and the MLP's partial
    outputs (2 + 2 x 2 = 5 of (2, 32, 128) bf16), and all-gathers the last
    position's vocab-split logits once ((2, 256) bf16)."""
    cfg = get_smoke_config("llama3.2-1b")
    rows, seq = TINY["prefill_tiny"][1] // 4, TINY["prefill_tiny"][0]
    c = port[("llama3.2-1b", "prefill_tiny")]["counts"]
    n_ar = 1 + 2 * cfg.n_layers
    assert c["collective_counts"] == {"all-reduce": n_ar, "all-gather": 1}
    assert c["collectives"] == {"all-reduce": n_ar * rows * seq * cfg.d_model * 2,
                                "all-gather": rows * cfg.vocab // 2 * 2}
    assert c["collective_bytes"] == sum(c["collectives"].values())


def test_production_dry_run_in_seconds_without_allocating(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
    train_4k --mesh single``: the 16 x 16 production mesh (a fake world of
    256), rank 0's step on 4,096-token rows, in seconds, nothing allocated."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}", OMP_NUM_THREADS="1")
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "llama3.2-1b", "--shape", "train_4k", "--mesh", "single",
                           "--json-out", str(out)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    seconds = time.monotonic() - t
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert seconds < 60, seconds
    assert rec["counts"]["allocated_bytes"] == 0
    assert rec["counts"]["dot_flops"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert not pathlib.Path(REPO / "results" / "dryrun").exists()


def test_roofline_on_h100_constants():
    """The H100 SXM's published figures, and repro's keys."""
    assert (cost_analysis.PEAK_FLOPS_BF16, cost_analysis.HBM_BW, cost_analysis.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = cost_analysis.roofline_terms(hlo_flops=989e12, hlo_bytes=6.7e12,
                                     coll_bytes_per_device=450e9, n_chips=8)
    assert t == {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 1.0,
                 "dominant": "memory_s", "bound_s": 2.0}
    src = pathlib.Path(cost_analysis.__file__).read_text()
    assert not re.search(r"\b(197e12|819e9|50e9)\b", src)  # repro's TPU v5e constants
