"""The zoo's optimizer steps and the pieces around the train step on the
CPU, held to the JAX package: three ``adamw(warmup_cosine)`` steps against
the reference's ``make_train_step`` (tinyllama and paligemma with its
prefix), ``sgd`` and ``adamw(moment_dtype=bfloat16)``; ``make_eval_step``; ``launch/train.py``'s ``train_local`` from
the reference's own draws (its init params and each step's synthetic
batch, carried over as data) and its launcher (``--local`` on the CPU, the
refusal without it, the CUDA default of its entry points); checkpoints
crossing between the packages both ways (bf16 bit for bit, the ``.json``
side file, ``nbytes_of``); ``MetricLogger``'s rows, files and aggregates;
``token_stream``; ``dwa_projected`` against ``dwa_jax`` at K = 3;
``quantization_error``; ``layer_norm``, ``count_params`` and
``tree_cast``.  The losses, gradients and optimizer steps themselves are
``test_torch_zoo_train.py``'s, whose helpers this file shares.

Tolerances: float32 on both sides; losses within 1e-5, and within 1e-4
after four AdamW steps; params after SGD steps within 1e-5 of their scale,
after AdamW steps by ``close_after_adam`` (AdamW's steps on gradients near
0 carry the sums' order, see ``test_torch_zoo_train.py``).
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.core.weighting import dwa_jax
from repro.launch import train as train_ref
from repro.models import get_model as get_model_ref
from repro.models import nn as nn_ref
from repro.serving import quantize as quantize_ref
from repro.streams.sources import token_stream as token_stream_ref
from repro.training import checkpoint as checkpoint_ref
from repro.training import adamw as adamw_ref
from repro.training import make_eval_step as make_eval_step_ref
from repro.training import make_train_step as make_train_step_ref
from repro.training import sgd as sgd_ref
from repro.training import warmup_cosine as warmup_cosine_ref
from repro.training.metrics import MetricLogger as MetricLoggerRef
from repro_torch.convert import params_from_numpy
from repro_torch.core.weighting import dwa_projected
from repro_torch.launch import train
from repro_torch.models import nn
from repro_torch.models.model import get_model
from repro_torch.serving.quantize import quantization_error
from repro_torch.streams.sources import token_stream
from repro_torch.training import checkpoint
from repro_torch.training.metrics import MetricLogger
from repro_torch.training.optimizer import (adamw, sgd, tree_leaves,
                                            warmup_cosine)
from repro_torch.training.train_loop import make_eval_step, make_train_step

_spec = importlib.util.spec_from_file_location(
    "test_torch_zoo_train", Path(__file__).resolve().parent
    / "test_torch_zoo_train.py")
zt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(zt)
LOSS_ATOL = zt.LOSS_ATOL
reduced_pair, batch_for = zt.reduced_pair, zt.batch_for
torch_batch, jax_batch = zt.torch_batch, zt.jax_batch
close_tree, close_after_adam = zt.close_tree, zt.close_after_adam


def run_steps(arch, make_opt, make_opt_ref, n=3, **changes):
    """``n`` train steps of the port and the reference from the same params
    and batches: (port losses, reference losses, port params, reference
    params, port state, reference state)."""
    cfg_ref, p_ref, cfg, p = reduced_pair(arch, **changes)
    model, model_ref = get_model(cfg), get_model_ref(cfg_ref)
    opt, opt_ref = make_opt(), make_opt_ref()
    state, state_ref = opt.init(p), opt_ref.init(p_ref)
    step, step_ref = make_train_step(model, opt), jax.jit(
        make_train_step_ref(model_ref, opt_ref))
    losses, losses_ref = [], []
    for i in range(n):
        b = batch_for(cfg, seed=10 + i)
        p, state, m = step(p, state, torch_batch(b))
        p_ref, state_ref, m_ref = step_ref(p_ref, state_ref, jax_batch(b))
        losses.append(float(m["loss"]))
        losses_ref.append(float(m_ref["loss"]))
        assert abs(float(m["grad_norm"]) - float(m_ref["grad_norm"])) <= \
            1e-5 * float(m_ref["grad_norm"])
        if "lr" in m_ref:
            assert abs(float(m["lr"]) - float(m_ref["lr"])) <= 1e-9
    return losses, losses_ref, p, p_ref, state, state_ref


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
def test_adamw_warmup_cosine_steps_match_reference(arch):
    losses, losses_ref, p, p_ref, state, state_ref = run_steps(
        arch, lambda: adamw(warmup_cosine(1e-3, 1, 3)),
        lambda: adamw_ref(warmup_cosine_ref(1e-3, 1, 3)))
    np.testing.assert_allclose(losses, losses_ref, atol=LOSS_ATOL, rtol=0)
    assert losses[-1] < losses[0]
    close_after_adam(p, p_ref, 1e-3, 3)
    close_tree(state.mu, state_ref.mu, rtol=1e-3)
    assert int(state.step) == int(state_ref.step) == 3


def test_sgd_and_bf16_moments_match_reference():
    losses, losses_ref, p, p_ref, state, _ = run_steps(
        "tinyllama-1.1b", lambda: sgd(0.05, momentum=0.9),
        lambda: sgd_ref(0.05, momentum=0.9), n=2)
    np.testing.assert_allclose(losses, losses_ref, atol=LOSS_ATOL, rtol=0)
    close_tree(p, p_ref, rtol=1e-5)
    assert state.mu is state.nu
    losses, losses_ref, p, p_ref, state, state_ref = run_steps(
        "tinyllama-1.1b",
        lambda: adamw(1e-3, moment_dtype="bfloat16", weight_decay=0.1),
        lambda: adamw_ref(1e-3, moment_dtype=jnp.bfloat16,
                          weight_decay=0.1), n=2)
    np.testing.assert_allclose(losses, losses_ref, atol=LOSS_ATOL, rtol=0)
    close_after_adam(p, p_ref, 1e-3, 2)
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(state.mu))
    # a moment off by one bf16 rounding where the f32 values straddle one
    close_tree(state.nu, state_ref.nu, rtol=2.0**-7)


def test_make_eval_step_matches_reference():
    cfg_ref, p_ref, cfg, p = reduced_pair("tinyllama-1.1b")
    b = batch_for(cfg)
    got = make_eval_step(get_model(cfg))(p, torch_batch(b))
    want = jax.jit(make_eval_step_ref(get_model_ref(cfg_ref)))(
        p_ref, jax_batch(b))
    assert sorted(got) == sorted(want) == ["aux", "loss", "xent"]
    for k in got:
        assert got[k].grad_fn is None
        assert abs(float(got[k]) - float(want[k])) <= LOSS_ATOL


def reference_draws(arch, steps, batch, seq):
    """The reference's ``train_local`` draws: its init params and each
    step's synthetic batch, numpy."""
    cfg_ref = get_config_ref(arch).reduced()
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray,
                                    get_model_ref(cfg_ref).init(key))
    batches = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append({k: np.array(v) for k, v in
                        train_ref.synthetic_batch(cfg_ref, batch, seq,
                                                  sub).items()})
    return params, batches


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
def test_train_local_matches_reference_draws(arch):
    steps, batch, seq = 4, 2, 16
    want = train_ref.train_local(arch, steps, batch, seq, 3e-3,
                                 log_every=0)
    params, batches = reference_draws(arch, steps, batch, seq)
    got = train.train_local(arch, steps, batch, seq, 3e-3, log_every=0,
                            device="cpu",
                            params=params_from_numpy(params, "cpu"),
                            batches=batches)
    # four AdamW steps at lr 3e-3: the losses' sums' order, as above
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4,
                               rtol=0)
    assert got["first_loss"] == got["losses"][0]
    assert got["final_loss"] == got["losses"][-1]


def test_train_local_draws_and_launcher_on_the_cpu(tmp_path, capsys):
    res = train.train_local("paligemma-3b", 3, 2, 8, 1e-3, log_every=1,
                            device="cpu", ckpt_path=str(tmp_path / "c"))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert "step 3/3" in capsys.readouterr().out
    restored = checkpoint.load(str(tmp_path / "c"), device="cpu")
    for a, b in zip(tree_leaves(restored), tree_leaves(res["params"])):
        assert torch.equal(a, b)
    cfg = get_config_ref("paligemma-3b").reduced()
    gen = torch.Generator().manual_seed(0)
    b = train.synthetic_batch(cfg, 2, 8, gen)
    assert b["tokens"].shape == b["targets"].shape == (2, 8)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["prefix_embed"].shape == (2, 8, 64)
    train.main(["--arch", "tinyllama-1.1b", "--local", "--steps", "2",
                "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert "done: first_loss=" in capsys.readouterr().out
    # without --local the launcher points to the dry run and exits 0, as
    # the reference's points to its own
    train.main(["--arch", "tinyllama-1.1b"])
    assert ("python -m repro_torch.launch.dryrun --arch tinyllama-1.1b "
            "--shape train_4k") in capsys.readouterr().out
    # the recurrent families train too: two steps on one batch, the loss
    # finite and falling
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        cfg = get_config_ref(arch).reduced()
        b = {k: v.numpy() for k, v in train.synthetic_batch(
            cfg, 2, 8, torch.Generator().manual_seed(1)).items()}
        res = train.train_local(arch, 2, 2, 8, 1e-3, log_every=0,
                                device="cpu", batches=[b, b])
        assert np.isfinite(res["losses"]).all(), arch
        assert res["losses"][1] < res["losses"][0], arch


def test_train_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_local("tinyllama-1.1b", 1, 1, 4, 1e-3)
    checkpoint.save(str(tmp_path / "c"), {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load(str(tmp_path / "c"))


def test_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    tree = {"layers": {"w": torch.tensor(f32),
                       "b": torch.tensor(bf).to(torch.bfloat16)},
            "step_count": torch.tensor([7], dtype=torch.int32)}
    h = checkpoint.save(str(tmp_path / "port"), tree, step=3,
                        meta={"arch": "x"})
    assert h.path.endswith(".npz") and h.step == 3
    assert h.nbytes == checkpoint.nbytes_of(tree) == 60 + 48 + 4
    assert json.loads(Path(h.path + ".json").read_text()) == {
        "step": 3, "meta": {"arch": "x"}}
    got_ref = checkpoint_ref.load(h.path)
    np.testing.assert_array_equal(np.asarray(got_ref["layers"]["w"]), f32)
    assert got_ref["layers"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got_ref["layers"]["b"]).view(np.uint16),
        tree["layers"]["b"].view(torch.int16).numpy().view(np.uint16))
    # and back: the reference's file in the port
    tree_ref = {"layers": {"w": jnp.asarray(f32),
                           "b": jnp.asarray(bf, jnp.bfloat16)}}
    h_ref = checkpoint_ref.save(str(tmp_path / "ref.npz"), tree_ref)
    got = checkpoint.load(h_ref.path, device="cpu")
    assert got["layers"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["layers"]["b"], tree["layers"]["b"])
    assert torch.equal(got["layers"]["w"], tree["layers"]["w"])
    assert checkpoint.nbytes_of(got) == checkpoint_ref.nbytes_of(tree_ref)
    assert not Path(h_ref.path + ".json").exists()


def test_metric_logger_rows_match_reference(tmp_path):
    rows = [(1, {"loss": 2.5, "lr": torch.tensor(1e-3), "tag": "a"}),
            (2, {"loss": torch.tensor(2.0), "grad_norm": 0.5}),
            (3, {"loss": 1.5, "lr": 2e-3})]
    ours = MetricLogger(str(tmp_path / "port.jsonl"))
    ref = MetricLoggerRef(str(tmp_path / "ref.jsonl"))
    for step, m in rows:
        ours.log(step, **m)
        ref.log(step, **{k: (float(v) if isinstance(v, torch.Tensor) else v)
                         for k, v in m.items()})
    ours.close()
    ref.close()
    for a, b in ((ours, ref), (MetricLoggerRef.read(ours.path),
                              MetricLogger.read(ref.path))):
        strip = [[{k: v for k, v in r.items() if k != "time"}
                  for r in x._rows] for x in (a, b)]
        assert strip[0] == strip[1]
        assert a.summary() == b.summary()
        assert a.series("loss") == b.series("loss") == [2.5, 2.0, 1.5]
        assert a.mean("lr") == b.mean("lr")
        assert a.mean("loss", last_n=2) == b.mean("loss", last_n=2)


def test_token_stream_matches_reference():
    for n, vocab, seed, drift in ((200, 16, 0, None), (300, 9, 3, 150)):
        np.testing.assert_array_equal(
            token_stream(n, vocab, seed, drift),
            token_stream_ref(n, vocab, seed, drift))


def test_dwa_projected_matches_reference_at_k3():
    rng = np.random.default_rng(5)
    y = rng.standard_normal(120).astype(np.float32)
    preds = np.stack([y + 0.3 * rng.standard_normal(120),
                      0.5 * y + 0.1 * rng.standard_normal(120),
                      rng.standard_normal(120)]).astype(np.float32)
    for steps, lr in ((200, 0.5), (7, 0.9)):
        got = dwa_projected(preds, y, n_steps=steps, lr=lr)
        want = np.asarray(dwa_jax(jnp.asarray(preds), jnp.asarray(y),
                                  n_steps=steps, lr=lr))
        assert got.dtype == np.float32 and got.shape == (3,)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert abs(float(got.sum()) - 1) < 1e-5 and (got >= 0).all()


def test_quantization_error_matches_reference():
    cfg_ref, p_ref, cfg, p = reduced_pair("codeqwen1.5-7b")
    got = quantization_error(p)
    want = quantize_ref.quantization_error(p_ref)
    assert sorted(got) == sorted(want) and len(got) > 5
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-7, k
        assert 0 < got[k] < 0.01


def test_layer_norm_count_params_tree_cast():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = nn.layer_norm(torch.tensor(x).to(dt), torch.tensor(g),
                            torch.tensor(b), 1e-5)
        want = nn_ref.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g),
                                 jnp.asarray(b), 1e-5)
        assert got.dtype == dt
        tol = 1e-5 if dt == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    cfg_ref, p_ref, cfg, p = reduced_pair("grok-1-314b")
    assert nn.count_params(p) == nn_ref.count_params(p_ref) > 0
    tree = {"w": torch.ones(2, 3), "i": torch.ones(2, dtype=torch.int32),
            "n": {"v": torch.zeros(4, dtype=torch.float64)}}
    cast = nn.tree_cast(tree, torch.bfloat16)
    assert cast["w"].dtype == cast["n"]["v"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32
    cast_ref = nn_ref.tree_cast(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), tree), jnp.bfloat16)
    assert cast_ref["i"].dtype == jnp.int32
    assert cast_ref["w"].dtype == jnp.bfloat16
