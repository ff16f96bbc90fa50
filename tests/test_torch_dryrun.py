"""The port's dry run (``launch/dryrun.py``) against the reference's: every
(arch, shape) traced on ``meta`` at a depth of 2 gives the reference's
applicability, and its FLOP count is ``model_flops`` with every term the
analytic count leaves out or counts otherwise added back, term by term.
Then ``tests/test_launch.py``'s override cases on the port, the kept-out
forms refused, the mesh, the step specs, ``main`` and the train launcher
without ``--local``; and the Zamba2 hybrid with fewer layers than
``attn_every``, which the dry run's depth cut reaches, against the
reference."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as SHAPES_REF
from repro.configs import get_config as get_config_ref
from repro.configs import shape_applicable as shape_applicable_ref
from repro.launch.dryrun import OPTIMIZED_PRESETS as PRESETS_REF
from repro.models.model import get_model as get_model_ref
from repro_torch.configs import ASSIGNED, H100, SHAPES, get_config, get_shape
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import gated_ffn_params, model_flops
from repro_torch.launch.dryrun import (OPTIMIZED_PRESETS, apply_overrides,
                                       parse_overrides, run_one)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.model import get_model
from repro_torch.models.moe import group_and_capacity

SRC = Path(__file__).resolve().parents[1] / "src"
DEPTH = 2
# the traced count against the term-by-term expectation below, relative,
# by family: every term is accounted for, so only float rounding is left
TRACED_RTOL = {"dense": 1e-9, "moe": 1e-9, "vlm": 1e-9, "ssm": 1e-9,
               "hybrid": 1e-9, "audio": 1e-9}


def traced_flops(cfg, shape) -> float:
    """What the dry run's trace counts with ``remat="none"``, from
    ``model_flops``: the analytic count (6 N D train, 2 N D inference, and
    the attention's products, causal halved) with what it leaves out, or
    counts otherwise than the port computes, taken out or added back."""
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    V, d, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    qd, kvd = cfg.q_dim, cfg.kv_dim
    mult = 6 if kind == "train" else 2
    ntok = B if kind == "decode" else B * S
    attn_p = 2 * d * qd + 2 * d * kvd
    x = model_flops(cfg, shape)
    # the input embedding is a gather, not a product
    if not cfg.tie_embeddings:
        x -= mult * V * d * ntok
    # the head runs over the text positions at train (the VLM's prefix
    # has no targets) and over the last position only at prefill
    P = cfg.frontend.n_prefix_tokens if cfg.family == "vlm" else 0
    head_rows = {"train": B * (S - P), "prefill": B, "decode": B}[kind]
    x -= mult * V * d * (ntok - head_rows)
    # self-attention: #6's plain version computes every (query, key) pair,
    # 4 B Sq Sk q_dim forward and 10 backward; model_flops halves a causal
    # span and takes the backward as twice the forward: 14 / 6 of it at
    # train and 2 at prefill for causal full attention, 1 at decode
    sq = 1 if kind == "decode" else S
    a_mult = 3 if kind == "train" else 1
    fb = 14 if kind == "train" else 4
    if cfg.attention != "none":
        n_attn = L if cfg.family != "hybrid" else L // cfg.hybrid.attn_every
        swa = cfg.attention == "swa"
        skv_model = min(S, cfg.window_size) if swa else S
        if sq > 1 and not swa:
            skv_model /= 2
        skv = min(S, cfg.window_size) if kind == "decode" and swa else S
        x += (fb * skv - 4 * a_mult * skv_model) * B * sq * qd * n_attn
    # a frontend's projector over its frames (at train its weight's
    # gradient too, the frames need none)
    if cfg.frontend is not None and kind != "decode":
        fe = cfg.frontend
        x += ((4 if kind == "train" else 2) * B * fe.n_prefix_tokens
              * fe.embed_dim * d)
    # MoE: on meta every expert runs its full capacity, the reference's
    # one-hot dispatch's work, where model_flops counts top_k experts
    if cfg.moe is not None:
        m = cfg.moe
        g3 = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
        no_drop = (kind != "train" and cfg.moe_exact_serving
                   and m.n_experts <= 64)
        n_groups, _, cap = group_and_capacity(
            cfg, 1 if kind == "decode" else S, no_drop=no_drop)
        rows = m.n_experts * cap * n_groups * B
        x += (mult * g3 * d * m.d_ff_expert * (rows - m.top_k * ntok)
              * (L - m.first_dense_layers))
    # RWKV6: the channel mix's receptance, the ddlerp and decay LoRAs,
    # which model_flops leaves out, and #7 (2 B T H N^2 forward, 6 back)
    if cfg.family == "ssm":
        H, N = d // cfg.rwkv.head_size, cfg.rwkv.head_size
        lora = 2 * 5 * 32 * d + 2 * cfg.rwkv.decay_lora * d
        x += mult * (d * d + lora) * ntok * L
        T = 1 if kind == "decode" else S
        x += (8 if kind == "train" else 2) * B * T * H * N * N * L
    # Zamba2: #8, and the shared block applied once a super-layer where
    # model_flops counts its params once
    if cfg.family == "hybrid":
        _, H, _, _ = ssm_mod.dims(cfg)
        T = 1 if kind == "decode" else S
        x += ((8 if kind == "train" else 2) * B * T * H * cfg.ssm.head_dim
              * cfg.ssm.state_dim * L)
        shared = attn_p + gated_ffn_params(cfg, d) + 2 * d * d
        x += mult * shared * ntok * (L // cfg.hybrid.attn_every - 1)
    # the encoder-decoder: the encoder and the cross K/V run over the M
    # frames, not the tokens; the encoder's self-attention is not causal
    # and runs at prefill too; at decode the cross K/V come from the cache
    if cfg.family == "audio":
        M, ne = cfg.encdec.encoder_len, cfg.encdec.n_encoder_layers
        if kind != "decode":
            enc = ne * (attn_p + gated_ffn_params(cfg, d))
            x += mult * (enc + L * 2 * d * kvd) * (B * M - ntok)
            x += fb * B * M * M * qd * ne
            if kind == "train":
                x -= 12 * B * M * M / 2 * qd * ne
        else:
            x -= 2 * L * 2 * d * kvd * B
        x += (fb - 4 * a_mult) * B * sq * M * qd * L
    return x


def _quiet(capsys):
    capsys.readouterr()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", [c.name for c in ASSIGNED])
def test_run_one_at_depth_2_matches_the_references_applicability_and_flops(
        arch, shape, capsys):
    rec = run_one(arch, shape, remat="none", overrides={"n_layers": DEPTH})
    _quiet(capsys)
    ref = get_config_ref(arch).replace(n_layers=DEPTH)
    ok, why = shape_applicable_ref(ref, SHAPES_REF[shape])
    assert rec["mesh"] == "1xH100"
    if not ok:
        assert rec == {"arch": arch, "shape": shape, "mesh": "1xH100",
                       "status": "skip", "skip_reason": why}
        return
    assert rec["status"] == "ok" and rec["n_chips"] == 1
    cfg = apply_overrides(get_config(arch), {"n_layers": DEPTH})
    summ, rl = rec["step_summary"], rec["roofline"]
    want = traced_flops(cfg, get_shape(shape))
    assert summ["dot_flops"] == pytest.approx(
        want, rel=TRACED_RTOL[cfg.family]), (arch, shape)
    assert rl["model_flops"] == model_flops(cfg, get_shape(shape))
    assert rl["useful_ratio"] == rl["model_flops"] / summ["dot_flops"]
    assert rl["compute_s"] == summ["dot_flops"] / H100.peak_flops_bf16
    assert rl["memory_s"] == summ["traffic_bytes"] / H100.hbm_bw
    assert rl["collective_s"] == 0.0 and summ["collectives"] == {}
    assert summ["aten_flops"] + summ["kernel_flops"] == summ["dot_flops"]
    mem = rec["memory"]
    n_bytes = {"train": ("params", "opt_state", "batch"),
               "prefill": ("params", "batch"),
               "decode": ("params", "batch", "cache")}[get_shape(shape).kind]
    assert mem["argument_bytes"] == sum(mem[f"{k}_bytes"] for k in n_bytes)
    assert mem["argument_bytes"] <= mem["peak_bytes"] == rec[
        "bytes_per_device"]
    assert mem["fits"] == (mem["peak_bytes"] <= 80e9)
    json.dumps(rec)  # the record is what main writes


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_remat_block_recomputes_the_forward(arch, capsys):
    """Under ``remat="block"`` (the dry run's default) the traced backward
    recomputes each block's forward, so the step counts more than
    ``remat="none"``, as the reference's ``useful_ratio`` shows; the peak
    memory falls."""
    ov = {"n_layers": 6}
    none = run_one(arch, "train_4k", remat="none", overrides=ov)
    block = run_one(arch, "train_4k", overrides=ov)
    _quiet(capsys)
    assert (block["step_summary"]["dot_flops"]
            > none["step_summary"]["dot_flops"])
    assert block["roofline"]["useful_ratio"] < none["roofline"][
        "useful_ratio"]
    assert block["memory"]["peak_bytes"] < none["memory"]["peak_bytes"]


def test_override_cases_of_test_launch_on_the_port():
    """``tests/test_launch.py``'s override cases: types, nested moe.*
    keys leaving the original untouched, every preset valid."""
    ov = parse_overrides(["attn_chunk=2048", "moe.capacity_factor=1.0",
                          "scan_chunked=true", "attn_p_dtype=bfloat16"])
    assert ov == {"attn_chunk": 2048, "moe.capacity_factor": 1.0,
                  "scan_chunked": True, "attn_p_dtype": "bfloat16"}
    cfg = get_config("grok-1-314b")
    cfg2 = apply_overrides(cfg, {"moe.ep_mode": "shard_map",
                                 "attn_chunk": 512})
    assert cfg2.moe.ep_mode == "shard_map" and cfg2.attn_chunk == 512
    assert cfg.moe.ep_mode == "auto"
    for arch, preset in OPTIMIZED_PRESETS.items():
        assert apply_overrides(get_config(arch), preset).name == arch
    # the reference's presets, less the entries that select a kept-out
    # form (and the knobs that go with it)
    for arch, preset in PRESETS_REF.items():
        port = OPTIMIZED_PRESETS.get(arch, {})
        assert port.items() <= preset.items(), arch
        if port != preset:
            with pytest.raises(ValueError, match="keeps out"):
                dryrun.refuse_kept_out(get_config(arch), preset)


def test_kept_out_forms_are_refused_by_name(capsys):
    with pytest.raises(ValueError, match="moe_shard_map"):
        run_one("grok-1-314b", "decode_32k",
                overrides={"moe.ep_mode": "shard_map", "n_layers": 1})
    with pytest.raises(ValueError, match="ssd_chunked"):
        run_one("zamba2-1.2b", "train_4k", overrides={"scan_chunked": True})
    # RWKV6's chunked scan is ported: its preset runs
    rec = run_one("rwkv6-3b", "decode_32k",
                  overrides={**OPTIMIZED_PRESETS["rwkv6-3b"], "n_layers": 1})
    _quiet(capsys)
    assert rec["status"] == "ok"


def test_mesh_is_one_h100_and_multi_pod_is_refused():
    mesh = make_production_mesh()
    assert (mesh.name, mesh.n_chips, mesh.hw) == ("1xH100", 1, H100)
    with pytest.raises(ValueError, match="distributed/sharding.py"):
        make_production_mesh(multi_pod=True)


def test_build_step_specs_are_meta_tensors():
    """``tests/test_launch.py``'s step-spec case on the port: the decode
    step's token, pos and a seq_len cache, every input on meta; the train
    step's params, AdamW state and batch."""
    fn, specs = build_step(get_config("tinyllama-1.1b"),
                           get_shape("decode_32k"))
    leaves = torch.utils._pytree.tree_leaves(specs)
    assert all(t.device.type == "meta" for t in leaves)
    assert specs["batch"]["token"].shape == (128, 1)
    assert specs["batch"]["pos"].shape == (128,)
    assert specs["cache"]["k"].shape[2] == 32768
    logits, cache = fn(**specs)
    assert logits.shape == (128, 32000) and logits.device.type == "meta"
    assert cache["k"].shape == specs["cache"]["k"].shape
    _, specs = build_step(get_config("rwkv6-3b"), get_shape("train_4k"))
    assert set(specs) == {"params", "opt_state", "batch"}
    assert specs["batch"]["tokens"].shape == (256, 4096)
    assert specs["opt_state"].mu["tok_embed"].dtype == torch.float32


def test_main_writes_records(tmp_path, capsys):
    out = tmp_path / "dry"
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--set", "n_layers=2", "--out", str(out), "--tag", "t"])
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                 "--out", str(out), "--optimized"])
    printed = capsys.readouterr().out
    assert "-> tinyllama-1.1b_decode_32k_1xH100_t: ok" in printed
    assert "-> tinyllama-1.1b_long_500k_1xH100_opt: skip" in printed
    rec = json.loads((out / "tinyllama-1.1b_decode_32k_1xH100_t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["roofline"]["dominant"] == "memory"
    with pytest.raises(SystemExit, match="1 dry-run combos failed"):
        dryrun.main(["--arch", "grok-1-314b", "--shape", "decode_32k",
                     "--set", "moe.ep_mode=shard_map", "--out", str(out)])
    rec = json.loads((out / "grok-1-314b_decode_32k_1xH100.json")
                     .read_text())
    assert rec["status"] == "fail" and "moe_shard_map" in rec["error"]


def test_launchers_run_as_modules(tmp_path):
    """``launch/train.py`` without ``--local`` points to the dry run and
    exits 0, as the reference's points to its own; the dry run runs as a
    module, without a card."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b"], capture_output=True, text=True, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ("python -m repro_torch.launch.dryrun --arch tinyllama-1.1b "
            "--shape train_4k") in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "zamba2-1.2b", "--shape", "long_500k", "--set", "n_layers=2",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "-> zamba2-1.2b_long_500k_1xH100: ok" in proc.stdout


def test_hybrid_without_a_super_layer_matches_the_reference():
    """Zamba2 with fewer layers than ``attn_every`` runs no shared block,
    which the reference's scans of length 0 allow: prefill's logits and
    empty K/V cache, and a train step whose shared block's gradients are
    zero, as ``jax.grad`` gives them."""
    from repro_torch.training.optimizer import sgd
    from repro_torch.training.train_loop import make_train_step

    ref_cfg = get_config_ref("zamba2-1.2b").reduced()
    ref_cfg = ref_cfg.replace(hybrid=dataclasses.replace(
        ref_cfg.hybrid, attn_every=6))
    cfg = get_config("zamba2-1.2b").reduced()
    cfg = cfg.replace(hybrid=dataclasses.replace(cfg.hybrid, attn_every=6))
    ref_params = get_model_ref(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ref_params), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17),
                                             dtype=np.int32)
    want, _ = get_model_ref(ref_cfg).prefill(
        ref_params, {"tokens": jnp.asarray(toks[:, :16])}, 24)
    with torch.no_grad():
        got, cache = get_model(cfg).prefill(
            params, {"tokens": torch.as_tensor(toks[:, :16])}, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert cache["k"].shape == (0, 2, 24, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: get_model_ref(ref_cfg).loss_fn(p, batch)[0])(ref_params)
    shared = {k: v.clone() for k, v in params["shared"].items()}
    opt = sgd(1.0)
    params, _, metrics = make_train_step(get_model(cfg), opt)(
        params, opt.init(params),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(metrics["loss"]) == pytest.approx(float(ref_loss), abs=1e-5)
    for leaf in jax.tree_util.tree_leaves(ref_grads["shared"]):
        assert not np.asarray(leaf).any()
    # a zero gradient leaves the shared block as it was under SGD
    for k, v in shared.items():
        assert torch.equal(params["shared"][k], v), k
