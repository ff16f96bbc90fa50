"""The port's analysis tools against the reference's: the input shapes and
their applicability, the analytic parameter and FLOP counts, the meta
input specs and param trees, each kernel's FLOP formula on ``meta``
against ``FlopCounterMode`` over its plain version, and the roofline.

``tests/test_analysis.py`` is the reference's test of its HLO parser,
``model_flops`` and ``roofline``; the parser has no counterpart (the port
has no HLO), the rest is held here to the reference's values."""
import dataclasses

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED as ASSIGNED_REF
from repro.configs import REGISTRY as REGISTRY_REF
from repro.configs import SHAPES as SHAPES_REF
from repro.configs import TPU_V5E
from repro.configs import shape_applicable as shape_applicable_ref
from repro.launch import analysis as analysis_ref
from repro.models.model import get_model as get_model_ref
from repro.models.model import input_specs as input_specs_ref
from repro.training.optimizer import adamw as adamw_ref
from repro_torch.configs import (ASSIGNED, H100, REGISTRY, SHAPES,
                                 HardwareModel, get_config, get_shape,
                                 shape_applicable)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.int8_matmul import ops as int8_ops
from repro_torch.kernels.int8_matmul import ref as int8_ref
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell import ref as lstm_ref
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.launch import analysis
from repro_torch.launch.steps import param_opt_specs
from repro_torch.models.model import get_model, input_specs
from repro_torch.serving.quantize import QTensor

ARCHS = sorted(REGISTRY)


def test_shapes_and_assigned_archs_are_the_references():
    assert list(SHAPES) == list(SHAPES_REF)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            SHAPES_REF[name])
        assert get_shape(name) == shape
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")
    assert [c.name for c in ASSIGNED] == [c.name for c in ASSIGNED_REF]
    assert sorted(REGISTRY) == sorted(REGISTRY_REF)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicability_and_analytic_counts_equal_the_references(arch):
    """``shape_applicable``, ``count_params_analytic``, ``gated_ffn_params``
    and ``model_flops`` equal the reference's to the last float."""
    cfg, ref = get_config(arch), REGISTRY_REF[arch]
    assert cfg.has_decoder == ref.has_decoder
    assert (analysis.count_params_analytic(cfg)
            == analysis_ref.count_params_analytic(ref))
    assert (analysis.gated_ffn_params(cfg, cfg.d_model)
            == analysis_ref.gated_ffn_params(ref, ref.d_model))
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == shape_applicable_ref(
            ref, SHAPES_REF[name])
        assert (analysis.model_flops(cfg, shape)
                == analysis_ref.model_flops(ref, SHAPES_REF[name]))


def test_model_flops_moe_active_vs_total():
    """The reference's case on the port: kimi-k2 is 1T-class in total and
    ~32B-class active, and a train step counts more than a decode step."""
    cfg = get_config("kimi-k2-1t-a32b")
    total, active = analysis.count_params_analytic(cfg)
    assert total > 7e11 and active < 0.1 * total
    assert (analysis.model_flops(cfg, get_shape("train_4k"))
            > analysis.model_flops(cfg, get_shape("decode_32k")))


def _flat(tree, prefix=""):
    """path -> (shape, dtype name) of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape),
                               str(v.dtype).removeprefix("torch."))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch):
    """Keys, shapes and dtypes of every applicable shape's inputs, each a
    tensor on ``meta`` (a decode cache from ``init_cache`` on meta)."""
    cfg, ref = get_config(arch), REGISTRY_REF[arch]
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        got = input_specs(cfg, shape)
        assert _flat(got) == _flat(input_specs_ref(ref, SHAPES_REF[name])), (
            arch, name)
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(got))


@pytest.mark.parametrize("arch", [c.name for c in ASSIGNED])
def test_param_opt_specs_equal_eval_shape_of_the_references_init(arch):
    """The meta params and AdamW's state against ``jax.eval_shape`` of the
    reference's ``model.init`` and ``opt.init``, leaf by leaf under the
    paths ``convert.params_from_numpy`` pairs, at full size, in both
    moment dtypes; the generator is never drawn from."""
    cfg, ref = get_config(arch), REGISTRY_REF[arch]
    want = _flat(jax.eval_shape(get_model_ref(ref).init,
                                jax.random.PRNGKey(0)))
    for moment in ("float32", "bfloat16"):
        params, state, _ = param_opt_specs(cfg.replace(
            opt_moment_dtype=moment))
        assert _flat(params) == want
        ref_state = jax.eval_shape(
            adamw_ref(1e-4, moment_dtype=moment).init,
            jax.eval_shape(get_model_ref(ref).init, jax.random.PRNGKey(0)))
        for got_m, want_m in ((state.mu, ref_state.mu),
                              (state.nu, ref_state.nu)):
            assert _flat(got_m) == _flat(want_m)
        assert state.step.shape == ref_state.step.shape == ()
        assert all(t.device.type == "meta" for t in
                   torch.utils._pytree.tree_leaves((params, state)))
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state().clone()
    get_model(cfg).init(gen, "meta")
    assert torch.equal(gen.get_state(), before)


# ---------------------------------------------------------------------------
# each kernel's FLOP formula on meta against FlopCounterMode over ref.py
# ---------------------------------------------------------------------------


def _count(fn, *args):
    """FlopCounterMode's total and its count by op name over fn(*args)."""
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    by_op = {str(k): v for k, v in
             fc.get_flop_counts().get("Global", {}).items()}
    return fc.get_total_flops(), by_op


def _rand(*shape):
    return torch.randn(shape, generator=_GEN)


_GEN = torch.Generator().manual_seed(0)


def _meta(*tensors, grad=False):
    return [torch.empty_like(t, device="meta").requires_grad_(
        grad and t.is_floating_point()) for t in tensors]


def _lstm_case(streams):
    lead = (streams,) if streams else ()
    x = _rand(*lead, 3, 4, 5)
    wx, wh, b = _rand(*lead, 5, 24), _rand(*lead, 6, 24), _rand(*lead, 24)
    return x, wx, wh, b


@pytest.mark.parametrize("streams", [0, 2])
def test_lstm_sequence_formulas_equal_the_plain_versions(streams):
    """#1 (no grad), #2 and #3 (under grad), with and without a stream
    axis: the meta ops' formulas against the plain versions' products."""
    x, wx, wh, b = _lstm_case(streams)
    want_1, _ = _count(lstm_ref.lstm_sequence_ref, x, wx, wh, b)
    want_2, _ = _count(lstm_ref.lstm_sequence_fwd_train_ref, x, wx, wh, b)
    gates, c_seq, h_seq = lstm_ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
    dh = torch.ones_like(h_seq[..., -1, :])
    want_3, _ = _count(lstm_ref.lstm_sequence_bwd_ref, x, gates, c_seq,
                       h_seq, wx, wh, dh, torch.zeros_like(dh))
    mx, mwx, mwh, mb = _meta(x, wx, wh, b)
    with torch.no_grad():
        got_1, by_op = _count(lstm_ops.lstm_sequence, mx, mwx, mwh, mb)
    assert by_op == {"repro_torch.lstm_sequence": want_1} and want_1 > 0
    gx, gwx, gwh, gb = _meta(x, wx, wh, b, grad=True)

    def step():
        h = lstm_ops.lstm_sequence(gx, gwx, gwh, gb)
        assert h.shape == dh.shape and h.device.type == "meta"
        torch.autograd.grad(h.sum(), (gx, gwx, gwh, gb))

    _, by_op = _count(step)
    assert by_op == {"repro_torch.lstm_sequence_fwd_train": want_2,
                     "repro_torch.lstm_sequence_bwd": want_3}


def test_lstm_cell_and_scan_formulas_equal_the_plain_versions():
    """#5: one step and the per-step scan (T launches)."""
    x, wx, wh, b = _lstm_case(0)
    h, c = _rand(3, 6), _rand(3, 6)
    want, _ = _count(lstm_ref.lstm_cell_ref, x[:, 0], h, c, wx, wh, b)
    want_scan, _ = _count(lstm_ref.lstm_sequence_scan_ref, x, wx, wh, b)
    assert want_scan == 4 * want
    with torch.no_grad():
        m = _meta(x[:, 0].contiguous(), h, c, wx, wh, b)
        _, by_op = _count(lstm_ops.lstm_step, *m)
        assert by_op == {"repro_torch.lstm_cell": want}
        _, by_op = _count(lstm_ops.lstm_sequence_scan, *_meta(x, wx, wh, b))
        assert by_op == {"repro_torch.lstm_cell": want_scan}


@pytest.mark.parametrize("streams", [0, 3])
def test_int8_matmul_formula_equals_the_plain_version(streams):
    lead = (streams,) if streams else ()
    x = _rand(*lead, 7, 5)
    q = torch.randint(-127, 128, (*lead, 5, 9), generator=_GEN,
                      dtype=torch.int8)
    scale = _rand(*lead, 9).abs()
    want, _ = _count(int8_ref.int8_matmul_ref, x, q, scale)
    mx, mq, ms = _meta(x, q, scale)
    qt = QTensor(q=mq, scale=ms, orig_dtype="float32")
    with torch.no_grad():
        _, by_op = _count(int8_ops.qmatmul, mx, qt)
    assert by_op == {"repro_torch.int8_matmul": want} and want > 0
    y = int8_ops.qmatmul(mx, qt)
    assert y.shape == (*lead, 7, 9) and y.dtype == x.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_formulas_equal_the_plain_versions(dtype):
    """#6's forward (every (query, key) pair, masked after) and its
    backward, at GQA with Sq != Sk."""
    B, Sq, Sk, Hq, Hkv, D = 2, 5, 7, 4, 2, 8
    q, k, v = (_rand(B, Sq, Hq, D), _rand(B, Sk, Hkv, D),
               _rand(B, Sk, Hkv, D))
    q_pos = torch.arange(Sk - Sq, Sk).expand(B, Sq)
    kv_pos = torch.arange(Sk).expand(B, Sk)
    want_f, _ = _count(flash_ref.attend_full_ref, q, k, v, q_pos, kv_pos)
    o = flash_ref.attend_full_ref(q, k, v, q_pos, kv_pos)
    want_b, _ = _count(flash_ref.flash_attend_bwd_ref, q, k, v, o,
                       torch.ones_like(o), q_pos, kv_pos)
    assert want_f == 4 * B * Sq * Sk * Hq * D
    assert want_b == 10 * B * Sq * Sk * Hq * D
    mq, mk, mv = _meta(q.to(dtype), k.to(dtype), v.to(dtype), grad=True)
    mqp, mkp = _meta(q_pos, kv_pos)

    def step():
        out = flash_ops.flash_attend(mq, mk, mv, mqp, mkp)
        assert out.shape == q.shape and out.dtype == dtype
        grads = torch.autograd.grad(out.sum(), (mq, mk, mv))
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]

    _, by_op = _count(step)
    assert by_op == {"repro_torch.flash_attention": want_f,
                     "repro_torch.flash_attention_backward": want_b}


@pytest.mark.parametrize("state", [False, True])
def test_wkv_formulas_equal_the_plain_versions(state):
    """#7's forward and its backward, from a zero state and from one."""
    B, T, H, N = 2, 5, 3, 8
    r, k, v = (_rand(B, T, H, N) for _ in range(3))
    w = torch.rand((B, T, H, N), generator=_GEN)
    u = _rand(H, N)
    s0 = _rand(B, H, N, N) if state else None
    want_f, _ = _count(wkv_ref.wkv_ref, r, k, v, w, u, s0)
    want_b, _ = _count(wkv_ref.wkv_bwd_ref, r, k, v, w, u, s0,
                       torch.ones_like(r), None)
    args = _meta(*(t for t in (r, k, v, w, u, s0) if t is not None),
                 grad=True)
    if not state:
        args.append(None)

    def step():
        y, s = wkv_ops.wkv(*args)
        assert y.shape == r.shape and s.shape == (B, H, N, N)
        torch.autograd.grad(y.sum(), [a for a in args if a is not None])

    _, by_op = _count(step)
    assert by_op == {"repro_torch.wkv": want_f,
                     "repro_torch.wkv_backward": want_b}
    with torch.no_grad():
        out = torch.empty((B, H, N, N), device="meta")
        _, s = wkv_ops.wkv(*args, out=out)
        assert s is out


@pytest.mark.parametrize("state", [False, True])
def test_selective_scan_formulas_equal_the_plain_versions(state):
    """#8's forward and its backward, from a zero state and from one."""
    B, T, H, P, N = 2, 5, 3, 4, 6
    x = _rand(B, T, H, P)
    b, c = _rand(B, T, N), _rand(B, T, N)
    dt = torch.rand((B, T, H), generator=_GEN)
    a, d = -torch.rand(H, generator=_GEN), _rand(H)
    s0 = _rand(B, H, P, N) if state else None
    want_f, _ = _count(ssm_ref.selective_scan_ref, x, b, c, dt, a, d, s0)
    want_b, _ = _count(ssm_ref.selective_scan_bwd_ref, x, b, c, dt, a, d, s0,
                       torch.ones_like(x), None)
    args = _meta(*(t for t in (x, b, c, dt, a, d, s0) if t is not None),
                 grad=True)
    if not state:
        args.append(None)

    def step():
        y, s = ssm_ops.selective_scan(*args)
        assert y.shape == x.shape and s.shape == (B, H, P, N)
        torch.autograd.grad(y.sum(), [t for t in args if t is not None])

    _, by_op = _count(step)
    assert by_op == {"repro_torch.selective_scan": want_f,
                     "repro_torch.selective_scan_backward": want_b}


@pytest.mark.parametrize("arch,n_layers,attn_every", [
    ("rwkv6-3b", 2, None), ("zamba2-1.2b", 2, 6)])
def test_meta_train_step_counts_what_the_cpu_path_computes(arch, n_layers,
                                                           attn_every):
    """A reduced train step traced on meta counts exactly the FLOPs of the
    same step run on the CPU, where each kernel is its plain version: the
    kernels' formulas stand for the products ``ref.py`` computes (Zamba2
    with fewer layers than ``attn_every``: no attention, whose CPU path is
    the chunked scan rather than the plain version)."""
    from repro_torch.launch.steps import build_step
    from repro_torch.configs import InputShape
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch).reduced().replace(n_layers=n_layers)
    if attn_every:
        cfg = cfg.replace(hybrid=dataclasses.replace(cfg.hybrid,
                                                     attn_every=attn_every))
    shape = InputShape("tiny", 16, 2, "train")
    fn, kwargs = build_step(cfg, shape)
    summary, _ = analysis.trace_step(fn, kwargs)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw(1e-4)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=_GEN)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    total, _ = _count(make_train_step(model, opt), params, opt.init(params),
                      batch)
    assert summary.dot_flops == total and summary.kernel_flops > 0


# ---------------------------------------------------------------------------
# the trace's bytes and the roofline
# ---------------------------------------------------------------------------


def test_trace_step_counts_bytes_and_follows_live_storages():
    """Each op's inputs and outputs count as traffic, a view counts
    nothing; the peak is the arguments plus the most intermediates alive
    at once, a graph's saved tensors among them until it is freed."""
    n = 256  # (n, n) float32: 256 KiB a tensor
    x, w = (torch.empty((n, n), device="meta") for _ in range(2))
    t = n * n * 4

    def no_grad(x, w):
        a = x @ w  # x, w in; a out
        b = a.relu()  # a in, b out; a and b live
        del a
        c = b.t()  # a view: no bytes, no storage
        return c @ w  # b (through c), w in; out

    summ, out = analysis.trace_step(no_grad, {"x": x, "w": w})
    assert summ.dot_flops == 2 * 2 * n**3
    assert summ.param_bytes == 2 * t and summ.output_bytes == t
    assert summ.traffic_bytes == (3 + 2 + 3) * t + 2 * t + t
    assert summ.peak_bytes == 4 * t  # x, w, a, b
    assert summ.n_ops == 4 and out.shape == (n, n)

    wg = torch.empty((n, n), device="meta", requires_grad=True)

    def grad(x, w):
        h = (x @ w).relu()  # the matmul's output dies, relu's is saved
        return torch.autograd.grad((h @ w).sum(), w)[0]

    summ, _ = analysis.trace_step(grad, {"x": x, "w": wg})
    # x, w, the product (freed after relu), relu's output (saved), the
    # second product, its sum's ones and the gradients
    assert 5 * t <= summ.peak_bytes <= 7 * t
    # two products forward; backward dW and dH of the second, dW of the
    # first (x needs no gradient)
    assert summ.dot_flops == 5 * 2 * n**3


def test_roofline_equals_the_references_with_its_tpu_numbers():
    """The port's roofline, given the reference's TPU_V5E and the same
    summary numbers, equals the reference's; on the H100 the collective
    term is 0."""
    cases = [(1e12, 1e9, 1e12, {"all-reduce": 1e12}, 256, 1e15),
             (5e14, 2e12, 0.0, {}, 1, 3e14),
             (1e9, 1e12, 4e8, {"all-gather": 4e8}, 512, 1e11)]
    for flops, traffic, coll, colls, chips, mf in cases:
        ref_summ = analysis_ref.HLOSummary(
            dot_flops=flops, traffic_bytes=traffic, collective_bytes=coll,
            collectives=colls, n_while=0, trip_counts=[], param_bytes=0,
            output_bytes=0)
        port_summ = analysis.StepSummary(
            dot_flops=flops, traffic_bytes=traffic, param_bytes=0,
            output_bytes=0, peak_bytes=0, n_ops=0, flops_by_op={},
            collective_bytes=coll, collectives=colls)
        want = analysis_ref.roofline(ref_summ, chips, mf).as_dict()
        assert analysis.roofline(port_summ, chips, mf,
                                 TPU_V5E).as_dict() == want
        tpu = HardwareModel(**dataclasses.asdict(TPU_V5E))
        assert analysis.roofline(ref_summ, chips, mf, tpu).as_dict() == want
    one_card = analysis.StepSummary(
        dot_flops=1e9, traffic_bytes=1e12, param_bytes=0, output_bytes=0,
        peak_bytes=0, n_ops=0, flops_by_op={})
    r = analysis.roofline(one_card, 1, 1e11)
    assert r.collective_s == 0.0 and H100.ici_bw == 0.0
    assert r.compute_s == 1e9 / 989e12 and r.memory_s == 1e12 / 3.35e12
    assert r.dominant == "memory" and r.useful_ratio == 1e11 / 1e9
    assert (H100.peak_flops_bf16, H100.hbm_bw, H100.hbm_bytes,
            H100.vmem_bytes) == (989e12, 3.35e12, 80e9, 228 * 1024)
