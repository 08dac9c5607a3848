"""The port's LM training side over a device mesh, on CPU ranks under gloo,
against repro:

  (i)    ``param_specs``, ``opt_state_specs`` and ``cache_specs`` equal
         repro's leaf for leaf (through ``convert``'s names) for every
         config and its smoke config;
  (ii)   ``shard_state`` then ``gather_state`` is the identity;
  (iii)  two mesh steps equal repro's one-device step on the global batch
         (worlds 8 at (2, 2, 2), 4 at (1, 1, 4) and (1, 4, 1), 2 at
         (1, 1, 2); every family, MoE with drops, microbatches, FSDP), and
         the parameters and moments live split as the specs say;
  (iv)   the llama step against repro's GSPMD step on an ``AxisType.Auto``
         (2, 2, 2) mesh;
  (v)    ``compressed_psum_mean`` and the compressed step against repro's
         under a pure data-parallel ``jax.shard_map`` on 4 devices;
  (vi)   ``ep_manual`` against the gspmd path and repro's ``apply_moe``, and
         with drops against repro's run per data-parallel block;
  (vii)  a checkpoint saved on world 8 restores on world 4 and on one
         device to the same state;
  (viii) what must raise instead of falling back;
  (ix)   chip_smoke.py's phase 14 rehearsed on the CPU.

Each world is one spawned run of ``tests/torch_dist_ranks.py`` (processes
that import torch and repro_torch only); repro's multi-device references
run in one subprocess of their own (``tests/lm_mesh_jax.py``, 8 fake
devices). Losses and grad norms to 1e-5 relative, parameters to 1e-5
absolute, at fp32 and the smoke sizes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_config  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.models.layers import ShardCtx as RShardCtx  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.convert import _param_paths, _stacked_tree, train_state_to_numpy  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import ShardCtx  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402
from tests.test_torch_distributed import REPO, join, start  # noqa: E402

WORLDS = {  # name: (size, shape, cases); world 4m waits for the checkpoint world 8 saves
    "8": (8, "2,2,2", "roundtrip,lmstep:llama,lmstep:dsv3_mb2,lmstep:llama_fsdp,lmstep:vlm,"
                      "lmstep:llama:cmp,cmp,ep,ckpt_save"),
    "4m": (4, "1,1,4", "roundtrip,lmstep:llama_mb2,lmstep:dsv3,lmstep:rwkv,lmstep64:rwkv,"
                       "lmstep:whisper,ep,ckpt_restore"),
    "4d": (4, "1,4,1", "roundtrip,lmstep:llama,lmstep:zamba,lmstep:dsv3,lmstep:llama_fsdp_mb2,"
                       "lmstep:llama:cmp,cmp"),
    "2": (2, "1,1,2", "roundtrip,lmstep:llama,lmstep:rwkv,lmstep64:rwkv,lmstep:zamba,lmstep:vlm,"
                      "lmstep:whisper,lm_refusals"),
}
STEP_CASES = [(w, c.split(":")[1]) for w, (_, _, cs) in WORLDS.items() for c in cs.split(",")
              if c.startswith("lmstep:") and not c.endswith(":cmp")]
JAX_LIMIT_S = 150.0
# repro's one-device steps, in subprocesses of about equal time beside the worlds
JAX_STEP_GROUPS = (("dsv3", "dsv3_mb2"), ("llama", "llama_mb2", "zamba"),
                   ("rwkv", "vlm", "whisper"))
EP_TOL = 2e-4  # tests/ep_check.py's logits tolerance


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_tree_close(out: dict, prefix: str, want, atol: float, rtol: float = 0.0) -> None:
    n = 0
    for path, w in _flat(want):
        got = out[prefix + "/" + "/".join(path)]
        np.testing.assert_allclose(got, np.asarray(w, np.float32), atol=atol, rtol=rtol,
                                   err_msg="/".join(path))
        n += 1
    assert n


# ---------------------------------------------------------------------------
# (i) the specs
# ---------------------------------------------------------------------------


def _as_tuple(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_repro(arch, smoke):
    """param_specs (by convert's names: repro's spec without the stacked
    layer dims), opt_state_specs and cache_specs equal repro's, at
    ShardCtx(16, cfg.fsdp) and ShardCtx(2, True / False), caches at batches
    8 / 32 / 64, max_len 512 / 4096, dp 16 / 32, one pod and two."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    rcfg = r_smoke(arch) if smoke else r_config(arch)
    model = Transformer(cfg, torch.device("meta"))
    for ms, fsdp in ((16, cfg.fsdp), (2, True), (2, False)):
        got = tfm.param_specs(cfg, ShardCtx(ms, fsdp))
        want = _as_tuple(rtfm.param_specs(rcfg, RShardCtx(ms, fsdp)))
        paths = list(_param_paths(model))
        assert set(got) == {name for name, *_ in paths}
        for name, _, path, index in paths:
            node = want
            for key in path:
                node = node[key]
            assert node[:len(index)] == (None,) * len(index), (name, node)
            assert got[name] == node[len(index):], (name, ms, fsdp, got[name], node)
        o = opt.opt_state_specs(got)
        assert o["m"] is got and o["v"] is got and o["step"] == tuple(
            ropt.opt_state_specs({})["step"])
    for batch in (8, 32, 64):
        for max_len in (512, 4096):
            for dp in (16, 32):
                for multi_pod in (False, True):
                    kw = dict(dp_size=dp, model_size=16, multi_pod=multi_pod)
                    assert tfm.cache_specs(cfg, batch, max_len, **kw) == _as_tuple(
                        rtfm.cache_specs(rcfg, batch, max_len, **kw)), (batch, max_len, kw)


# ---------------------------------------------------------------------------
# repro's references and the spawned worlds
# ---------------------------------------------------------------------------


def _r_cfg(name: str):
    arch, kw, mb = ranks.LM_CASES[name]
    return dataclasses.replace(r_smoke(arch), dtype="float32", **kw), mb


def _params(arch: str, **kw) -> dict:
    """Random fp32 parameters of ``arch``'s smoke config as repro's tree
    (drawn by the port, which is faster than JAX's eager draws here); the
    MoE router scaled for decisive routing."""
    from repro_torch.convert import model_params_to_numpy

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    tree = model_params_to_numpy(tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    if cfg.family == "moe":
        tree["layers"]["moe"]["router"] = tree["layers"]["moe"]["router"] * ranks.LM_ROUTER_SCALE
    return tree


def _ep_refs(inp):
    """repro's apply_moe program on one device: the logits and (aux loss
    off) the gradients of kimi-k2's smoke config at ep_check's settings;
    with drops, the logits of each data-parallel block alone."""
    cfg = dataclasses.replace(r_smoke(ranks.EP_ARCH), dtype="float32", **ranks.EP_CFG)
    params = jax.tree.map(jnp.asarray, ranks.unflatten_tree(inp, "ep_params"))
    tokens = jnp.asarray(inp["ep_tokens"])
    logits = np.asarray(jax.jit(rtfm.make_forward(cfg))(params, tokens)[0])
    coef = rtfm.AUX_LOSS_COEF
    rtfm.AUX_LOSS_COEF = 0.0
    try:
        grads = jax.jit(jax.grad(rtfm.make_loss_fn(cfg)))(params, {"tokens": tokens})
    finally:
        rtfm.AUX_LOSS_COEF = coef
    drops = dataclasses.replace(cfg, capacity_factor=ranks.EP_DROP_FACTOR)
    fwd = jax.jit(rtfm.make_forward(drops))
    per_block = {n: np.concatenate([np.asarray(fwd(params, blk)[0]) for blk in
                                    np.split(np.asarray(tokens), n)]) for n in (1, 4)}
    return logits, jax.tree.map(np.asarray, grads), per_block


def _port_one_device_steps(inp, name: str):
    """The port's one-device step from the same state on the same batches:
    losses, grad norms, and the state after each step (repro's tree)."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    cfg, mb = ranks.lm_config(name)
    model = model_params_from_numpy(cfg, ranks.unflatten_tree(inp, f"{name}_params"), "cpu")
    state = {"params": model, "opt": opt.init_opt_state(dict(model.named_parameters()),
                                                        opt.OptConfig(**ranks.LM_OPT))}
    step = make_train_step(cfg, TrainConfig(opt=opt.OptConfig(**ranks.LM_OPT), microbatches=mb))
    losses, norms, states = [], [], []
    for s in range(ranks.LM_STEPS):
        state, met = step(state, ranks.lm_batch(inp, name, s))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        states.append(ranks.flatten_tree(train_state_to_numpy(state), "s", {}))
    return np.asarray(losses), np.asarray(norms), states


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The inputs, the worlds and repro's multi-device references started,
    and the one-device references (repro's and the port's) computed while
    they run."""
    d = tmp_path_factory.mktemp("lm_mesh")
    rng = np.random.default_rng(0)
    inp = {"lm_tokens": rng.integers(0, 512, (ranks.LM_STEPS, ranks.LM_BATCH, ranks.LM_SEQ),
                                     dtype=np.int32)}
    drawn = {}
    for name, (arch, _, _) in ranks.LM_CASES.items():
        cfg, _ = _r_cfg(name)
        if arch not in drawn:  # the cases of one arch share its parameters
            drawn[arch] = _params(arch)
        ranks.flatten_tree(drawn[arch], f"{name}_params", inp)
        if cfg.family in ("vlm", "audio"):
            inp[f"{name}_frontend"] = rng.standard_normal(
                (ranks.LM_STEPS, ranks.LM_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                dtype=np.float32)
    for k, shape in ranks.CMP_LEAVES.items():
        inp[f"cmp_g_{k}"] = rng.standard_normal((4,) + shape, dtype=np.float32)
        inp[f"cmp_r_{k}"] = 0.01 * rng.standard_normal((4,) + shape, dtype=np.float32)
    ranks.flatten_tree(_params(ranks.EP_ARCH, **ranks.EP_CFG), "ep_params", inp)
    inp["ep_tokens"] = rng.integers(0, 512, ranks.EP_TOKENS, dtype=np.int32)
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    run_jax = lambda *args: subprocess.Popen(
        [sys.executable, "-m", "tests.lm_mesh_jax", str(d), *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # repro's one-device steps: the cases of one arch and microbatch count
    # share one (FSDP and remat do not change its values on one device)
    twins = {}
    for name, (arch, _, mb) in ranks.LM_CASES.items():
        twins.setdefault((arch, mb), name)
    jax_procs = [run_jax("mesh")] + [
        run_jax("steps", json.dumps({n: ranks.LM_CASES[n] for n in group}))
        for group in JAX_STEP_GROUPS]
    assert sorted(n for g in JAX_STEP_GROUPS for n in g) == sorted(twins.values())
    started = {}
    for name, (size, shape, cases) in WORLDS.items():
        wd = d / f"w{name}"
        wd.mkdir()
        (wd / "inputs.npz").symlink_to(d / "inputs.npz")
        started[name] = start(wd, size, shape, "pod,data,model", cases)
    port_steps = {name: _port_one_device_steps(inp, name) for name in ranks.LM_CASES}
    return types.SimpleNamespace(d=d, inp=inp, port_steps=port_steps, ep=_ep_refs(inp),
                                 jax_procs=jax_procs, started=started,
                                 twin={n: twins[(a, mb)] for n, (a, _, mb) in
                                       ranks.LM_CASES.items()})


@pytest.fixture(scope="module")
def worlds(ref):
    """Every world's ranks' outputs and repro's references: ``jax`` its
    multi-device ones, ``steps`` {case: (losses, grad norms, parameters)}
    of its one-device step."""
    outs = {name: join(handle) for name, handle in ref.started.items()}
    for proc in ref.jax_procs:
        try:
            log, _ = proc.communicate(timeout=JAX_LIMIT_S)
        except subprocess.TimeoutExpired:
            for p in ref.jax_procs:
                p.kill()
            pytest.fail(f"tests.lm_mesh_jax did not end within {JAX_LIMIT_S} s")
        assert proc.returncode == 0, log.decode()[-4000:]
    outs["jax"] = dict(np.load(ref.d / "jax_mesh.npz"))
    one = {}
    for group in JAX_STEP_GROUPS:
        one.update(np.load(ref.d / f"jax_steps_{group[0]}.npz"))
    outs["steps"] = {name: (one[f"{t}_loss"], one[f"{t}_gnorm"],
                            ranks.unflatten_tree(one, f"{t}_params"))
                     for name, t in ref.twin.items()}
    return outs


# ---------------------------------------------------------------------------
# (ii)-(ix)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_shard_then_gather_is_the_identity(worlds, world):
    for out in worlds[world]:
        assert out["roundtrip"].tolist() == [True] * 6


# The mesh step against the one-device step, the port's and repro's: sums
# in another order (the model axis's partial products, the data-parallel
# mean; repro's XLA programs), so the first step's gradients agree to
# rounding, read in its first moment m = 0.1 g / max(1, |g| / clip) (held
# to 1e-5 of each leaf's largest against the port's; 3e-5 for deepseek-v3,
# whose routing at 10x router logits, sharpened by softmax and the gate
# renormalisation, parts its gradients by more: 1.02e-5 measured). AdamW's
# first update m / (sqrt(v) + eps) is g / (|g| + eps): flat where |g| is
# well above eps, steep where the gradient nearly cancels (5e-9 against a
# leaf maximum of 9e-3 in one outlier of world 4's llama; 5e-8 against 6e-2
# in deepseek-v3's), and there rounding moves the update by up to a few
# 1e-5 of a step of lr 3e-4. Such elements, and only they, are excused from
# 1e-5 in the parameters: those whose first-step moment in the reference is
# at most ILL_M1 of its leaf's largest (measured at most 3.1e-4, deepseek-v3's
# dense w_gate; 1.3e-4 zamba2's out_proj), each still within a step's 2 lr
# (the port's one-device step has them against repro's too: up to 1.2e-4
# in deepseek-v3, 5.2e-5 in zamba2). The second step's grad norm reads
# those parameters: it is held at GNORM2 where that moves it past 1e-5
# (measured: deepseek-v3 1.15e-5 on the mesh, 1.2e-5 for the port's
# one-device step against repro's; rwkv6 2.5e-5 and 3.1e-5). The
# compressed mode's residuals are held to RES_TOL of each leaf's largest:
# r = (g + r) - q * scale rounds by up to an ulp of the leaf's largest
# |g + r| (127 scales) against a largest |r| of half a scale, and the two
# programs round it apart (XLA may fuse the product into the subtraction;
# measured at most 3.1e-5). rwkv6's block is tensor-parallel on the mesh:
# its row-parallel ``wo`` and channel-mix ``wv`` sum their partial products
# over the model axis in another order than one device's matmul, and the
# first step's gradient of this model amplifies fp32 rounding more than the
# others' (one device's fp32 gradient is itself 6.3e-5 of ``tm.u``'s largest
# from its float64 value; splitting ``wo`` and ``wv`` in two on one device
# moves it by 3.5e-5: examples/torch_rwkv_rounding.py), so its first
# moments are held to 3e-5 of each leaf's largest (measured 2.15e-5 at most:
# ``tm.u`` and ``cm.wr``, worlds 2 and 4m), like deepseek-v3's. That the
# gap is rounding and not a gradient fault is held in float64
# (``test_rwkv_mesh_gradients_match_in_float64``): there the mesh's first
# moments are the one-device step's to F64_M1.
ILL_M1 = 1e-3
F64_M1 = 1e-12  # measured 5.6e-14 (world 2) and 5.3e-14 (world 4m)
RES_TOL = 4 * 127 * 2.0 ** -23
MESH_M1 = {"dsv3": 3e-5, "dsv3_mb2": 3e-5, "rwkv": 3e-5}
GNORM2 = {"dsv3": 3e-5, "dsv3_mb2": 3e-5, "rwkv": 6e-5}


def assert_params_close(out: dict, prefix: str, want, m1, lr_max: float,
                        atol: float = 1e-5) -> None:
    """Every element of every leaf within ``atol`` but those whose
    first-step moment in the reference, ``m1`` (the tree of ``want``), is
    at most ILL_M1 of its leaf's largest |m1|: each of those within 2 lr_max."""
    for path, w in _flat(want):
        got = out[prefix + "/" + "/".join(path)]
        diff = np.abs(got - np.asarray(w, np.float32))
        far = diff > atol
        if far.any():
            m = m1
            for key in path:
                m = m[key]
            m = np.abs(np.asarray(m, np.float32))
            frac = m[far] / max(float(m.max()), 1e-30)
            assert float(frac.max()) <= ILL_M1, ("/".join(path), int(far.sum()),
                                                 float(frac.max()))
        assert diff.max() <= 2 * lr_max, ("/".join(path), float(diff.max()))


def assert_rel_to_max(got, want, tol: float, what: str) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (what, float(
        np.abs(got - want).max()) / scale)


@pytest.mark.parametrize("world", ["2", "4m"])
def test_rwkv_mesh_gradients_match_in_float64(worlds, world):
    """rwkv6's tensor-parallel mesh step and the one-device step, both in
    float64 from the same parameters and batch: the first moments (0.1 of
    the gradients) agree to F64_M1 of each leaf's largest, so the fp32 gap
    MESH_M1 allows is rounding (a gradient routed wrong through the time
    mix's head slices or the channel mix would show here in full)."""
    gap = float(worlds[world][0]["rwkv_m64_gap"])
    assert gap <= F64_M1, gap


@pytest.mark.parametrize("world,case", STEP_CASES)
def test_mesh_steps_match_one_device_repro(ref, worlds, world, case):
    """Two mesh steps against the one-device step on the global batch, the
    port's and repro's: losses and grad norms to 1e-5 relative on every
    rank, the gathered parameters to 1e-5 but for AdamW's ill-conditioned
    elements, the first moment after the first step to 1e-5 of each leaf's
    largest against the port's (the exceptions above); every leaf held as
    the block its spec gives, some split where the mesh splits."""
    p_losses, p_norms, p_states = ref.port_steps[case]
    losses, norms, params = worlds["steps"][case]
    for out in worlds[world]:
        for want_loss, want_norm in ((p_losses, p_norms), (losses, norms)):
            np.testing.assert_allclose(out[f"{case}_loss"], want_loss, rtol=1e-5)
            np.testing.assert_allclose(out[f"{case}_gnorm"][0], want_norm[0], rtol=1e-5)
            np.testing.assert_allclose(out[f"{case}_gnorm"][1], want_norm[1],
                                       rtol=GNORM2.get(case, 1e-5))
    out = worlds[world][0]
    for path, w in _flat(ranks.unflatten_tree(p_states[0], "s/opt/m")):
        assert_rel_to_max(out[f"{case}_state1/opt/m/" + "/".join(path)], w,
                          MESH_M1.get(case, 1e-5), "m " + "/".join(path))
    m1 = ranks.unflatten_tree(p_states[0], "s/opt/m")
    assert_params_close(out, f"{case}_state2/params",
                        ranks.unflatten_tree(p_states[-1], "s/params"), m1, ranks.LM_OPT["lr"])
    assert_params_close(out, f"{case}_state2/params", params, m1, ranks.LM_OPT["lr"])
    _, data, model = map(int, WORLDS[world][1].split(","))
    if model > 1 or (data > 1 and ranks.LM_CASES[case][1].get("fsdp")):
        assert int(out[f"{case}_split"]) > 0


def test_mesh_step_matches_repro_gspmd(ref, worlds):
    """World 8's llama steps against repro's GSPMD step on an Auto (2, 2, 2)
    mesh (which itself matches repro's one-device step)."""
    j = worlds["jax"]
    np.testing.assert_allclose(j["gspmd_loss"], worlds["steps"]["llama"][0], rtol=1e-5)
    for out in worlds["8"]:
        np.testing.assert_allclose(out["llama_loss"], j["gspmd_loss"], rtol=1e-5)
        np.testing.assert_allclose(out["llama_gnorm"], j["gspmd_gnorm"], rtol=1e-5)
    want = ranks.unflatten_tree(j, "gspmd_params")
    assert_tree_close(worlds["8"][0], "llama_state2/params", want, atol=1e-5)


@pytest.mark.parametrize("world", ["8", "4d"])
def test_compressed_psum_mean_matches_repro(worlds, world):
    """Each rank's int32 payload exactly, the mean to 1e-6 relative and the
    residual (the rank's own) to 1e-6 against repro's under a pure
    data-parallel shard_map on 4 devices (rank r of the data-parallel axes
    holds repro's device r's gradients)."""
    j = worlds["jax"]
    dp = {"8": lambda r: r // 2, "4d": lambda r: r}[world]
    for r, out in enumerate(worlds[world]):
        np.testing.assert_array_equal(out["cmp_q_sum"], j["cmp_q_sum"])
        for k in ranks.CMP_LEAVES:
            np.testing.assert_allclose(out[f"cmp_mean_{k}"], j[f"cmp_mean_{k}"], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(out[f"cmp_res_{k}"], j[f"cmp_res_{k}"][dp(r)],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", ["8", "4d"])
def test_compressed_step_matches_repro(ref, worlds, world):
    """Two compressed mesh steps, error feedback carried. Each
    data-parallel block's first-step gradients and loss against repro's
    one-device ones on that block (1e-5 of each leaf's largest; 1e-5);
    then repro's ``compressed_psum_mean`` (under ``jax.vmap`` over a named
    data axis of 4: the psum's semantics) and ``adamw_update`` fed the
    port's own block gradients and residuals of each step, against the
    port's new residuals (RES_TOL), loss, grad norm and parameters (1e-5,
    AdamW's ill-conditioned elements excepted as in
    ``test_mesh_steps_match_one_device_repro``). The mean rounds (g + r) /
    scale, so inputs that agree only to rounding (gradients of two
    programs; residuals that XLA's fused multiply-add and torch's separate
    product round apart) still fall on either side of a half at some
    elements, a whole quantum apart: it is held on the same inputs."""
    from repro.training.grad_compression import compressed_psum_mean as r_mean

    got = {k: v for out in worlds[world] for k, v in out.items()}
    cfg, _ = _r_cfg("llama")
    model = Transformer(dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32"),
                        torch.device("meta"))

    def block(prefix: str, r: int) -> dict:
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), _stacked_tree(model, {
            n: torch.as_tensor(got[f"llama_cmp_{prefix}_{r}/{n}"])
            for n, _ in model.named_parameters()}))

    def stacked(prefix: str) -> dict:
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[block(prefix, r) for r in range(4)])

    ocfg = ropt.OptConfig(**ranks.LM_OPT)
    params = jax.tree.map(jnp.asarray, ranks.unflatten_tree(ref.inp, "llama_params"))
    loss_fn = jax.jit(jax.value_and_grad(rtfm.make_loss_fn(cfg)))
    tokens = ref.inp["lm_tokens"][0]
    for r in range(4):
        loss, want = loss_fn(params, {"tokens": jnp.asarray(tokens[2 * r:2 * r + 2])})
        np.testing.assert_allclose(got[f"llama_cmp_raw0_loss{r}"], float(loss), rtol=1e-5)
        for path, w in _flat(want):
            g = block("raw0", r)
            for key in path:
                g = g[key]
            assert_rel_to_max(np.asarray(g), w, 1e-5, "/".join(path))
    mean_fn = jax.jit(jax.vmap(lambda g, res: r_mean(g, ("data",), res), axis_name="data"))
    update = jax.jit(lambda g, o, p: ropt.adamw_update(g, o, p, ocfg))
    opt_state = ropt.init_opt_state(params, ocfg)
    res = jax.tree.map(lambda p: jnp.zeros((4,) + p.shape, jnp.float32), params)
    for s in range(ranks.LM_STEPS):
        mean, new_res = mean_fn(stacked(f"raw{s}"), res)
        res = stacked(f"res{s}")
        for path, w in _flat(jax.tree.map(np.asarray, new_res)):
            g = res
            for key in path:
                g = g[key]
            np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=RES_TOL * float(
                np.abs(w).max()), err_msg=f"residual {s} {'/'.join(path)}")
        params, opt_state, met = update(jax.tree.map(lambda a: a[0], mean), opt_state, params)
        if s == 0:
            m1 = jax.tree.map(np.asarray, opt_state["m"])
        block_loss = np.mean([float(got[f"llama_cmp_raw{s}_loss{r}"]) for r in range(4)])
        for out in worlds[world]:
            np.testing.assert_allclose(out["llama_cmp_loss"][s], block_loss, rtol=1e-6)
            np.testing.assert_allclose(out["llama_cmp_gnorm"][s], float(met["grad_norm"]),
                                       rtol=1e-5)
    assert_params_close(worlds[world][0], "llama_cmp_state2/params",
                        jax.tree.map(np.asarray, params), m1, ranks.LM_OPT["lr"])


@pytest.mark.parametrize("world", ["8", "4m"])
def test_ep_manual_matches_gspmd_and_repro(ref, worlds, world):
    """At ep_check.py's settings: ep_manual's logits equal the gspmd path's
    and repro's apply_moe program's, and so do both paths' gradients with
    the aux loss off; with drops, ep_manual equals repro run on each
    data-parallel block alone."""
    logits, grads, per_block = ref.ep
    out = worlds[world][0]
    np.testing.assert_allclose(out["ep_ep_manual_logits"], out["ep_gspmd_logits"], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(out["ep_gspmd_logits"], logits, atol=EP_TOL, rtol=EP_TOL)
    model = Transformer(dataclasses.replace(get_smoke_config(ranks.EP_ARCH), **ranks.EP_CFG),
                        torch.device("meta"))
    for impl in ("gspmd", "ep_manual"):
        got = _stacked_tree(model, {name: torch.as_tensor(out[f"ep_{impl}_grad/{name}"])
                                    for name, _ in model.named_parameters()})
        for path, want in _flat(grads):
            g = got
            for key in path:
                g = g[key]
            assert_rel_to_max(g.numpy(), want, 1e-5, f"{impl} {'/'.join(path)}")
    n_dp = {"8": 4, "4m": 1}[world]
    np.testing.assert_allclose(out["ep_ep_manual_drops_logits"], per_block[n_dp], atol=EP_TOL,
                               rtol=EP_TOL)


def test_checkpoint_restores_across_meshes(ref, worlds):
    """World 8's state after its steps, saved there, restores on world 4 at
    (1, 1, 4), split as its specs say, and on one device, to the same
    state, bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.training.train_loop import TrainConfig, make_train_state

    saved = {k: v for k, v in worlds["8"][0].items() if k.startswith("llama_state2/")}
    restored = worlds["4m"][0]
    assert int(restored["ckpt_split"]) > 0
    for k, v in saved.items():
        np.testing.assert_array_equal(restored["ckpt_state/" + k[len("llama_state2/"):]], v)
    cfg, _ = ranks.lm_config("llama")
    tcfg = TrainConfig(opt=opt.OptConfig(**ranks.LM_OPT))
    target = make_train_state(cfg, tcfg, torch.Generator().manual_seed(9), "cpu")
    one = train_state_to_numpy(restore_checkpoint(
        ref.d / "ckpt", ranks.LM_STEPS, target))
    for path, v in _flat(one):
        np.testing.assert_array_equal(v, saved["llama_state2/" + "/".join(path)])


def test_no_fallback_on_the_lm_mesh(worlds):
    """A mesh of another world size, a dim its axis does not divide, a
    tensor of another device type, a mesh that is not a DeviceMesh, a state
    not placed on the mesh, ep_manual and the compressed mean off a mesh,
    and a cached decode on the mesh given no cache specs all raise (a
    prefill and decode on the mesh are tests/test_torch_lm_serve_mesh.py's)."""
    for out in worlds["2"]:
        assert out["lm_refusals"].tolist() == [1] * 8


def test_chip_smoke_phase14_rehearsal(monkeypatch, capsys):
    """chip_smoke.py's phase 14 on the CPU, under gloo in this process (its
    process group destroyed at the end of the phase), with the smoke configs
    in place of the full ones: (a)-(e) read, their gates held (the mesh step
    bit for bit against the local one, the compressed step's gradients and
    residual exactly, both prefills equal, the restores, both planted
    faults), launch counts 0 here."""
    import collections

    import chip_smoke as cs
    import repro_torch.configs as configs

    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "LM_MESH_PREFILL", (2, 16))
    results = collections.defaultdict(lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []})
    cs.phase_lm_mesh(results, device="cpu")
    text = capsys.readouterr().out
    for line in ("(a) local step", "flash_attention_bwd_dq llama3.2-1b mesh step",
                 "(b) compressed step",
                 "(c) deepseek-v3-671b at 4 layers", "(c) deepseek-v3-671b smoke, ep_manual",
                 "(d) saved on the mesh", "(e) a second compressed step"):
        assert f"phase 14 {line}" in text, line
    assert "FAILED" not in text
    assert not torch.distributed.is_initialized()


def test_train_cli_runs_under_torchrun(tmp_path):
    """``launch/train.py`` under torchrun on two gloo ranks: repro's mesh
    from the world size ((2, 1) over ("data", "model")), four steps under
    run_supervised with checkpoints written by rank 0, which restore on one
    device."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.training.train_loop import TrainConfig, make_train_state

    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke", "--steps", "4",
         "--seq", "16", "--batch", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh: {'data': 2, 'model': 1} (gloo)" in proc.stdout
    assert "done: 4 steps, 0 restarts" in proc.stdout
    assert latest_step(tmp_path) == 4
    cfg = get_smoke_config("llama3.2-1b")
    target = make_train_state(cfg, TrainConfig(), torch.Generator().manual_seed(0), "cpu")
    state = restore_checkpoint(tmp_path, 4, target)
    assert int(state["opt"]["step"]) == 4
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
