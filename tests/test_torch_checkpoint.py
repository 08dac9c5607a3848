"""The port's checkpointing and fault tolerance (``repro_torch.checkpoint``,
``repro_torch.runtime.fault_tolerance``), the counterparts of
tests/test_checkpoint_ft.py: atomic commit, retention, shape checks, the
on-disk layout shared with repro (a train state saved by either package
restores into the other, bit for bit, bf16 leaves included), restart
determinism under injected failures, straggler detection and elastic mesh
shapes.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402

from repro.checkpoint import restore_checkpoint as r_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as r_save  # noqa: E402
from repro.checkpoint.checkpoint import _tree_paths as r_tree_paths  # noqa: E402
from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro.training.train_loop import TrainConfig as RTrainConfig  # noqa: E402
from repro.training.train_loop import make_train_step as r_make_train_step  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailureInjector,
    StragglerMonitor,
    elastic_mesh_shape,
    run_supervised,
)
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    make_train_state,
    make_train_step,
)

ARCH = "llama3.2-1b"


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
              "d": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(tmp_path, 5, tree)
    assert latest_step(tmp_path) == 5
    out = restore_checkpoint(tmp_path, 5, tree)
    for key, want, got in (("a", tree["a"], out["a"]), ("c", tree["b"]["c"], out["b"]["c"]),
                           ("d", tree["b"]["d"], out["b"]["d"])):
        assert got.dtype == want.dtype and torch.equal(got, want), key
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["paths"] == ["['a']", "['b']/['c']", "['b']/['d']"]
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16", "int32"]
    assert np.load(tmp_path / "step_5" / "leaf_1.npy").dtype == np.uint16  # raw bf16 bits


def test_checkpoint_retention_and_markers(tmp_path):
    tree = {"w": torch.zeros(4)}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(tmp_path, s, tree, keep=2)
    assert all_steps(tmp_path) == [4, 5]
    assert not (tmp_path / "step_3").exists()
    # stale tmp dirs and uncommitted steps are never visible as committed steps
    (tmp_path / ".tmp_junk").mkdir()
    (tmp_path / "step_9").mkdir()
    assert all_steps(tmp_path) == [4, 5] and latest_step(tmp_path) == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="paths"):
        restore_checkpoint(tmp_path, 1, {"v": torch.zeros(4)})


@pytest.fixture(scope="module")
def repro_state():
    """A bf16 repro train state after one step (moments and step nonzero)."""
    cfg = dataclasses.replace(r_smoke_config(ARCH), vocab=128)
    ocfg = ropt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    params = rtfm.init_params(jax.random.key(0), cfg)
    state = {"params": params, "opt": ropt.init_opt_state(params, ocfg)}
    batch = RTokenPipeline(RDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0)
    state, _ = r_make_train_step(cfg, RTrainConfig(opt=ocfg), None, None)(state, batch)
    return state


def _port_cfg():
    return dataclasses.replace(get_smoke_config(ARCH), vocab=128)


def test_repro_train_state_restores_into_the_port(tmp_path, repro_state):
    r_save(tmp_path, 1, repro_state)
    cfg = _port_cfg()
    target = make_train_state(cfg, TrainConfig(), torch.Generator().manual_seed(5), "cpu")
    state = restore_checkpoint(tmp_path, 1, target)
    assert state["params"].embed.tok.dtype == torch.bfloat16
    got = train_state_to_numpy(state)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), repro_state)
    for path, (g, w) in zip(r_tree_paths(want),
                            zip(jax.tree.leaves(got), jax.tree.leaves(want))):
        np.testing.assert_array_equal(g, w, err_msg=path)
    assert int(state["opt"]["step"]) == 1


def test_port_train_state_restores_into_repro(tmp_path, repro_state):
    cfg = _port_cfg()
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, repro_state), "cpu")
    save_checkpoint(tmp_path, 4, state)
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert manifest["paths"] == r_tree_paths(repro_state)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(repro_state))
    out = r_restore(tmp_path, 4, repro_state)
    for path, a, b in zip(r_tree_paths(out), jax.tree.leaves(out), jax.tree.leaves(repro_state)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=path)


def _tiny_setup():
    cfg = dataclasses.replace(get_smoke_config(ARCH), vocab=128)
    tcfg = TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4), device="cpu")
    step_fn = make_train_step(cfg, tcfg)

    def make_state():
        return make_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")

    return make_state, step_fn, pipe


def test_restart_determinism(tmp_path):
    """Crashing at steps 7 and 13 and restarting from checkpoints yields the
    same losses as an uninterrupted run (deterministic data skip and a
    bit-exact restore)."""
    make_state, step_fn, pipe = _tiny_setup()
    ref = run_supervised(n_steps=20, make_state=make_state, train_step=step_fn,
                         batch_fn=pipe.batch, ckpt_dir=str(tmp_path / "ref"), ckpt_every=5)
    assert ref.restarts == 0
    rep = run_supervised(n_steps=20, make_state=make_state, train_step=step_fn,
                         batch_fn=pipe.batch, ckpt_dir=str(tmp_path / "crash"), ckpt_every=5,
                         injector=FailureInjector(fail_at={7, 13}))
    assert rep.restarts == 2 and rep.steps_done == 20
    # the crashed run replays steps 5-6 and 10-12; its last steps are the reference's
    np.testing.assert_array_equal(rep.losses[-7:], ref.losses[-7:])
    assert latest_step(tmp_path / "crash") == 20


def test_straggler_monitor():
    mon = StragglerMonitor(window=16, threshold=1.5)
    for _ in range(16):
        for host in range(4):
            mon.record(host, 1.0 if host != 2 else 2.2)
    assert mon.stragglers() == [2]
    assert 0.9 < mon.p50() < 2.0


def test_elastic_mesh_shapes():
    assert elastic_mesh_shape(512, 16, pod_size=16) == ((2, 16, 16), ("pod", "data", "model"))
    assert elastic_mesh_shape(256, 16, pod_size=16) == ((16, 16), ("data", "model"))
    assert elastic_mesh_shape(384, 16)[0] == (24, 16)
    with pytest.raises(AssertionError):
        elastic_mesh_shape(250, 16)
