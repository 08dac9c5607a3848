"""The port's training slice (``repro_torch.training``, ``make_loss_fn``,
``data.pipeline``, ``launch.train``) against repro's on the llama3.2-1b smoke
config, the counterparts of tests/test_training.py: the LR schedule; AdamW
on the same gradients and state (fp32 and bf16 parameters); clipping; int8
quantization; the loss and its gradients at fp32 with naive and flash
attention under every remat policy (1e-4: sums in another order); three
train steps from one carried-across state (losses to 1e-5);
microbatch accumulation; the loss going down; and the token pipeline bit for
bit. Inputs come from numpy seeds and go through both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro.training.grad_compression import quantize_int8 as r_quantize  # noqa: E402
from repro.training.train_loop import TrainConfig as RTrainConfig  # noqa: E402
from repro.training.train_loop import make_train_step as r_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    model_params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.grad_compression import (  # noqa: E402
    compressed_psum_mean,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    _accumulate_grads,
    make_train_state,
    make_train_step,
)

ARCH = "llama3.2-1b"
L = 32  # two flash blocks of 16 in repro


def _cfgs(**kw):
    return (dataclasses.replace(r_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _assert_trees_close(got: dict, want, tol: float):
    want = dict(_flat(_np_tree(want)))
    got = dict(_flat(got))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol, err_msg=str(key))


def _grads_tree(model, grads: dict) -> dict:
    """The port's gradients as repro's flattened tree (stacked over layers)."""
    from repro_torch.convert import _stacked_tree

    return {k: v.float().numpy() for k, v in _flat(_stacked_tree(model, grads))}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_repro():
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = [0, 5, 10, 11, 50, 99, 100, 150]
    got = [float(opt.lr_schedule(opt.OptConfig(**ocfg), torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(ropt.lr_schedule(ropt.OptConfig(**ocfg), jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0
    assert abs(got[1] - 5e-4) < 1e-9  # mid-warmup
    assert abs(got[2] - 1e-3) < 1e-9  # peak
    assert got[4] < got[2]
    assert abs(got[6] - 1e-4) < 1e-8  # min_lr_frac * lr


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"), ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_adamw_update_matches_repro(dtype, moments):
    """Three updates on the same gradients and state: parameters, moments,
    step and metrics equal repro's (fp32 to 1e-6; a bf16 parameter or moment
    within one bf16 ulp, both sides rounding once from fp32)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (3,), "c": (4, 2, 3)}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, moment_dtype=moments)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    rp = {k: jnp.asarray(a, jdt) for k, a in p0.items()}
    tp = {k: torch.tensor(np.asarray(rp[k], np.float32)).to(tdt) for k in p0}
    rstate = ropt.init_opt_state(rp, ropt.OptConfig(**cfg))
    tstate = opt.init_opt_state(tp, opt.OptConfig(**cfg))
    for it in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * (10.0 if it == 1 else 0.1)
             for k, s in shapes.items()}  # the second step clips
        rg = {k: jnp.asarray(a, jdt) for k, a in g.items()}
        tg = {k: torch.tensor(np.asarray(rg[k], np.float32)).to(tdt) for k in g}
        rp, rstate, rmet = ropt.adamw_update(rg, rstate, rp, ropt.OptConfig(**cfg))
        tmet = opt.adamw_update(tg, tstate, tp, opt.OptConfig(**cfg))
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(rmet["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmet["lr"]), float(rmet["lr"]), rtol=1e-6)
        assert int(tstate["step"]) == int(rstate["step"]) == it + 1
        for k in shapes:
            for got, want, dt in ((tp[k], rp[k], dtype), (tstate["m"][k], rstate["m"][k], moments),
                                  (tstate["v"][k], rstate["v"][k], moments)):
                assert str(got.dtype).removeprefix("torch.") == dt
                tol = 1e-6 if dt == "float32" else 2.0**-7
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=tol, atol=1e-7)


def test_grad_clipping_bounds_update():
    ocfg = opt.OptConfig(lr=1.0, warmup_steps=0, total_steps=10, clip_norm=1.0,
                         weight_decay=0.0)
    params = {"w": torch.ones(4)}
    st = opt.init_opt_state(params, ocfg)
    metrics = opt.adamw_update({"w": torch.full((4,), 1e6)}, st, params, ocfg)
    assert float(metrics["grad_norm"]) > 1e5
    assert bool(torch.isfinite(params["w"]).all())
    # clipped to norm 1: the first moment holds (1 - b1) * g / |g|
    np.testing.assert_allclose(st["m"]["w"].numpy(), np.full(4, 0.1 * 0.5), rtol=1e-5)


def test_int8_quantization_matches_repro_and_bound():
    g = np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32)
    q, scale = quantize_int8(torch.tensor(g))
    rq, rscale = r_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(scale), float(rscale), rtol=1e-7)
    deq = dequantize_int8(q, scale)
    assert float((deq - torch.tensor(g)).abs().max()) <= float(scale) / 2 + 1e-9
    with pytest.raises(ValueError, match="data-parallel ranks of a device mesh"):
        compressed_psum_mean({"w": torch.tensor(g)}, ("data",))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_model():
    """repro's fp32 smoke parameters, a batch, and repro's loss and
    gradients under naive and flash attention (blocks of 16)."""
    rcfg, _ = _cfgs(dtype="float32")
    params = rtfm.init_params(jax.random.key(0), rcfg)
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab, (2, L)).astype(np.int32)
    want = {}
    for impl in ("naive", "flash"):
        c = dataclasses.replace(rcfg, attn_impl=impl, flash_block_q=16, flash_block_k=16)
        loss, grads = jax.jit(jax.value_and_grad(rtfm.make_loss_fn(c)))(
            params, {"tokens": jnp.asarray(tokens)})
        want[impl] = (float(loss), grads)
    return _np_tree(params), tokens, want


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_repro(fp32_model, impl, remat):
    params, tokens, want = fp32_model
    _, cfg = _cfgs(dtype="float32", attn_impl=impl, remat=remat, flash_block_q=16,
                   flash_block_k=16)
    model = model_params_from_numpy(cfg, params, "cpu")
    loss = tfm.make_loss_fn(cfg)(model, {"tokens": torch.as_tensor(tokens)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want_loss, want_grads = want[impl]
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = _grads_tree(model, grads)
    want_flat = dict(_flat(_np_tree(want_grads)))
    assert got.keys() == want_flat.keys()
    for key, g in got.items():
        np.testing.assert_allclose(g, want_flat[key], rtol=1e-4, atol=1e-4, err_msg=str(key))


def test_remat_policies_give_the_same_gradients(fp32_model):
    """none, full and dots recompute the same ops on the same inputs: the
    gradients are equal bit for bit, for naive and flash attention."""
    params, tokens, _ = fp32_model
    for impl in ("naive", "flash"):
        out = {}
        for remat in ("none", "full", "dots"):
            _, cfg = _cfgs(dtype="float32", attn_impl=impl, remat=remat)
            model = model_params_from_numpy(cfg, params, "cpu")
            loss = tfm.make_loss_fn(cfg)(model, {"tokens": torch.as_tensor(tokens)})
            out[remat] = torch.autograd.grad(loss, list(model.parameters()))
        for remat in ("full", "dots"):
            assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat])), (impl, remat)


def test_loss_rejects_unported_heads():
    """The loss passes ``batch["frontend"]`` to a vlm model (which needs
    it) and rejects an unknown remat policy."""
    _, cfg = _cfgs()
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    vlm = dataclasses.replace(get_smoke_config("llama-3.2-vision-90b"), dtype="float32")
    vmodel = tfm.init_params(vlm, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frontend"):
        tfm.make_loss_fn(vlm)(vmodel, {"tokens": tokens})
    frontend = torch.zeros((1, 2, vlm.d_model), dtype=torch.bfloat16)
    loss = tfm.make_loss_fn(vlm)(vmodel, {"tokens": tokens, "frontend": frontend})
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="remat"):
        tfm.make_loss_fn(dataclasses.replace(cfg, remat="some"))(
            model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# train loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_three_train_steps_match_repro(impl):
    """Three make_train_step steps from one carried-across fp32 state, on
    repro's batches: losses and the final moments to 1e-5, parameters to
    2e-5. After the first step AdamW's update m / sqrt(v) is a ratio of
    gradient sums; where an element's successive gradients nearly cancel, it
    turns the ~1e-7 by which the two frameworks' fp32 sums differ into a few
    percent of a step (at lr 3e-4: 5 to 7 of 361,088 elements above 1e-6,
    the largest 7.3e-6 naive and 1.1e-5 flash)."""
    rcfg, cfg = _cfgs(dtype="float32", attn_impl=impl, flash_block_q=16, flash_block_k=16)
    ocfg = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    rparams = rtfm.init_params(jax.random.key(3), rcfg)
    rstate = {"params": rparams, "opt": ropt.init_opt_state(rparams, ropt.OptConfig(**ocfg))}
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    rpipe = RTokenPipeline(RDataConfig(vocab=rcfg.vocab, seq_len=L, global_batch=4))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=L, global_batch=4), device="cpu")
    rstep = r_make_train_step(rcfg, RTrainConfig(opt=ropt.OptConfig(**ocfg)), None, None)
    step = make_train_step(cfg, TrainConfig(opt=opt.OptConfig(**ocfg)))
    for s in range(3):
        rstate, rmet = rstep(rstate, rpipe.batch(s))
        state, met = step(state, pipe.batch(s))
        np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]), rtol=1e-6)
    got = train_state_to_numpy(state)
    assert int(got["opt"]["step"]) == int(rstate["opt"]["step"]) == 3
    _assert_trees_close(got["params"], rstate["params"], 2e-5)
    _assert_trees_close(got["opt"]["m"], rstate["opt"]["m"], 1e-5)
    _assert_trees_close(got["opt"]["v"], rstate["opt"]["v"], 1e-5)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_recurrent_train_steps_match_repro(arch):
    """Two make_train_step steps of the ssm and hybrid smoke configs from
    one carried-across fp32 state (remat "full": zamba2 recomputes whole
    groups of Mamba2 layers and the shared block), on repro's batches:
    losses to 1e-5, grad norms to 1e-4, lr to 1e-6, and the float32
    parameters (w0, u / a_log, d_skip, dt_bias) stay float32."""
    kw = dict(dtype="float32", remat="full")
    rcfg = dataclasses.replace(r_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    ocfg = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    rparams = rtfm.init_params(jax.random.key(3), rcfg)
    rstate = {"params": rparams, "opt": ropt.init_opt_state(rparams, ropt.OptConfig(**ocfg))}
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    rpipe = RTokenPipeline(RDataConfig(vocab=rcfg.vocab, seq_len=L, global_batch=2))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=L, global_batch=2), device="cpu")
    rstep = r_make_train_step(rcfg, RTrainConfig(opt=ropt.OptConfig(**ocfg)), None, None)
    step = make_train_step(cfg, TrainConfig(opt=opt.OptConfig(**ocfg)))
    for s in range(2):
        rstate, rmet = rstep(rstate, rpipe.batch(s))
        state, met = step(state, pipe.batch(s))
        np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]), rtol=1e-6)
    f32 = {n: p.dtype for n, p in state["params"].named_parameters()
           if n.split(".")[-1] in ("w0", "u", "a_log", "d_skip", "dt_bias")}
    assert f32 and set(f32.values()) == {torch.float32}


def test_microbatch_accumulation_equivalence(fp32_model):
    """Four microbatches of 2 against one batch of 8 (repro's tolerances),
    and against repro's four microbatches (1e-4); several microbatches give
    float32 gradients, one gives the parameters' dtype."""
    from repro.training.train_loop import _accumulate_grads as r_accumulate

    params, _, _ = fp32_model
    rcfg, cfg = _cfgs(dtype="float32")
    model = model_params_from_numpy(cfg, params, "cpu")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=L, global_batch=8), device="cpu")
    batch = pipe.batch(0)
    loss_fn = tfm.make_loss_fn(cfg)
    l1, g1 = _accumulate_grads(loss_fn, model, batch, 1)
    l4, g4 = _accumulate_grads(loss_fn, model, batch, 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    for name in g1:
        assert g4[name].dtype == torch.float32
        np.testing.assert_allclose(g1[name].numpy(), g4[name].numpy(), rtol=1e-3, atol=1e-5)
    rl4, rg4 = r_accumulate(rtfm.make_loss_fn(rcfg), jax.tree.map(jnp.asarray, params),
                            {"tokens": jnp.asarray(batch["tokens"].numpy())}, 4)
    np.testing.assert_allclose(float(l4), float(rl4), rtol=1e-5)
    got = _grads_tree(model, g4)
    for key, want in _flat(_np_tree(rg4)):
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-4, err_msg=str(key))
    with pytest.raises(ValueError, match="microbatches"):
        _accumulate_grads(loss_fn, model, batch, 3)

    bf = tfm.init_params(get_smoke_config(ARCH), torch.Generator().manual_seed(0), "cpu")
    _, g = _accumulate_grads(tfm.make_loss_fn(get_smoke_config(ARCH)), bf, batch, 1)
    assert all(t.dtype == torch.bfloat16 for t in g.values())


def test_loss_decreases():
    """As tests/test_training.py::test_loss_decreases, on the port's own
    random bf16 parameters."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), vocab=256)
    tcfg = TrainConfig(opt=opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8), device="cpu")
    state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    step_fn = make_train_step(cfg, tcfg)
    losses = []
    for s in range(30):
        state, metrics = step_fn(state, pipe.batch(s))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.25, losses
    assert all(np.isfinite(losses))


def test_train_step_rejects_mesh_and_compression():
    """A mesh must be a DeviceMesh (tests/test_torch_lm_mesh.py holds the
    mesh step); grad_compression without a mesh runs the plain step, as
    repro's does."""
    _, cfg = _cfgs(dtype="float32")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, TrainConfig(), mesh=object())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0),
                                     dtype=torch.int32)}
    out = []
    for compress in (False, True):
        tcfg = TrainConfig(grad_compression=compress)
        state = make_train_state(cfg, tcfg, torch.Generator().manual_seed(1), "cpu")
        state, met = make_train_step(cfg, tcfg)(state, batch)
        assert "residual" not in state
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    [p.detach().clone() for p in state["params"].parameters()]))
    assert out[0][:2] == out[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


# ---------------------------------------------------------------------------
# data and launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (7, 2)])
def test_token_pipeline_matches_repro_bit_for_bit(seed, n_hosts):
    kw = dict(vocab=1000, seq_len=24, global_batch=4, seed=seed)
    for host in range(n_hosts):
        rp = RTokenPipeline(RDataConfig(**kw), host_id=host, n_hosts=n_hosts)
        tp = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=n_hosts, device="cpu")
        for step in (0, 1, 9):
            got = tp.batch(step)["tokens"]
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(rp.batch(step)["tokens"]))
    batch = TokenPipeline(DataConfig(frontend_tokens=4, d_model=8, global_batch=2),
                          device="cpu").batch(0)
    assert tuple(batch["frontend"].shape) == (2, 4, 8)
    assert batch["frontend"].dtype == torch.bfloat16


def test_train_cli_runs_on_cpu(capsys, tmp_path):
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3", "--seq", "16", "--batch", "2",
                    "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("step ") == 3
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3", "--seq", "16", "--batch", "2",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert "done: 3 steps, 0 restarts" in capsys.readouterr().out
