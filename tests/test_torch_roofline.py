"""The port's roofline (``repro_torch.roofline``) on the CPU:

- the op counter's rules (``op_graph.count`` on meta tensors): a product's
  FLOPs and bytes, a Python loop counted per iteration, views for free, an
  in-place update into a persistent buffer at twice the update in the least
  traffic, the exact peak of live storages over a known sequence of
  allocations and frees, host values kept through small ops;
- agreement with the reference: ``model_flops``, ``param_count``,
  ``active_param_count``, ``kv_bytes_per_token`` and ``subquadratic`` for
  every registered config x shape, and ``RooflineTerms``' arithmetic (the
  reference's ``test_roofline_terms_math`` at ``HW_H100``);
- ``kernel_work`` at the shapes of ``PERF.md``'s kernel table: each bound
  to the table's 4 digits and the same "by";
- counting through the kernels on the smoke pipeline (qwen3-8b, N 4, M 8,
  C 16, B 2): the products through the ``torch`` backends equal
  ``FlopCounterMode``'s total; through ``cuda`` / ``paged`` the counted
  K1-K3 calls equal a CPU run's (its plain versions' calls, noted by
  ``ops.timed_launches``), the charges equal ``kernel_work`` of that run's
  own tensors, and they replace exactly the plain attention's products
  that the ``torch`` count had;
- K4 on the mamba2-130m smoke pipeline: the counted calls and charges equal
  a CPU run's calls and ``kernel_work`` of that run's own tensors;
- a counter is its own thread's: another thread sees none;
- a K2 mask with no host values makes ``count`` raise, and the meta branch
  runs neither the kernel nor the plain version.
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.roofline.analysis import model_flops as ref_model_flops
from repro_torch.configs import SHAPES, RunConfig, get_config, get_smoke_config, list_archs
from repro_torch.core import attention
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.kernels import ops, ref
from repro_torch.roofline import HW_H100, RooflineTerms, kernel_bound, kernel_work, model_flops
from repro_torch.roofline import op_graph
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

META = torch.device("meta")
MIB = 2 ** 20


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------ the counter

def test_matmul_costs_its_products_and_three_tensors():
    a, b = meta(1024, 1024), meta(1024, 1024)
    cost = op_graph.count(lambda x, y: x @ y, a, b)
    assert cost.flops == 2 * 1024 ** 3
    assert cost.bytes_ == 3 * 4 * MIB
    assert cost.stream_bytes == 3 * 4 * MIB      # both reads persistent, the output once
    assert cost.by_op["aten.mm"]["calls"] == 1


def test_python_loop_counts_every_iteration():
    a = meta(256, 256)

    def loop(x):
        for _ in range(10):
            y = x @ x
        return y

    cost = op_graph.count(loop, a)
    assert cost.flops == 10 * 2 * 256 ** 3
    assert cost.by_op["aten.mm"]["calls"] == 10


def test_views_cost_nothing():
    x = meta(1024)
    cost = op_graph.count(lambda t: t.view(64, 4, 4).permute(2, 0, 1).transpose(0, 1)[1:]
                          .unsqueeze(0).expand(3, -1, -1, -1).select(0, 1).squeeze(0), x)
    assert cost.bytes_ == 0.0 and cost.flops == 0.0
    assert cost.peak_live_bytes == 4 * 1024      # the argument alone


def test_index_copy_into_a_persistent_buffer_counts_twice_the_update():
    buf, upd = meta(100, 64), meta(10, 64)

    def write(b, u):
        b.index_copy_(0, torch.arange(10, device=META), u)

    cost = op_graph.count(write, buf, upd, persistent=(buf,))
    assert cost.by_op["aten.index_copy_"]["bytes"] == 2 * 10 * 64 * 4
    assert cost.stream_bytes == 2 * 10 * 64 * 4  # the index is an intermediate


def test_peak_live_bytes_is_exact():
    arg = meta(MIB // 4)                          # 1 MiB, live throughout

    def allocs(_):
        a = torch.empty(MIB, dtype=torch.uint8, device=META)
        b = torch.empty(2 * MIB, dtype=torch.uint8, device=META)
        del a                                     # freed before c is born
        c = torch.empty(4 * MIB, dtype=torch.uint8, device=META)
        d = b[:MIB].clone()                       # a view is no new storage, a clone is
        del b, c
        e = torch.empty(3 * MIB, dtype=torch.uint8, device=META)
        return d, e

    cost = op_graph.count(allocs, arg)
    assert cost.peak_live_bytes == (1 + 2 + 4 + 1) * MIB
    assert cost.argument_bytes == MIB and cost.output_bytes == 4 * MIB


def test_host_values_follow_small_ops():
    seen = {}

    def fn():
        valid = torch.as_tensor(np.array([True, False, True, True]), device=META)
        seen["valid"] = op_graph.host_value((valid[None] != 0).contiguous())
        lens = torch.full((3,), 7, dtype=torch.int32, device=META) + 1
        lens[1] = 2
        seen["lens"] = op_graph.host_value(lens)
        seen["none"] = op_graph.host_value(torch.empty(3, device=META))

    op_graph.count(fn)
    assert seen["valid"].tolist() == [[True, False, True, True]]
    assert seen["lens"].tolist() == [8, 2, 8]
    assert seen["none"] is None


# -------------------------------------------------- agreement with reference

@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_counts_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.subquadratic == rcfg.subquadratic
    for b in (1, 2):
        assert cfg.kv_bytes_per_token(b) == rcfg.kv_bytes_per_token(b)
    assert set(SHAPES) == set(REF_SHAPES)
    for name, shape in SHAPES.items():
        rs = REF_SHAPES[name]
        assert (shape.name, shape.kind, shape.seq_len, shape.global_batch) == \
            (rs.name, rs.kind, rs.seq_len, rs.global_batch)
        assert model_flops(cfg, shape) == ref_model_flops(rcfg, rs)


def test_roofline_terms_math():
    peak, bw = HW_H100["peak_flops"], HW_H100["hbm_bw"]
    t = RooflineTerms(flops_dev=peak, bytes_dev=bw / 2, coll_dev=0.0,
                      coll_by_kind={}, chips=2, model_flops=2 * peak)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.dominant == "compute"
    assert t.useful_ratio == pytest.approx(1.0)
    assert t.roofline_fraction == pytest.approx(1.0)
    assert RooflineTerms.from_dict(t.to_dict()).to_dict() == t.to_dict()
    m = RooflineTerms(flops_dev=peak / 4, bytes_dev=bw, coll_dev=0.0, coll_by_kind={},
                      chips=1, model_flops=peak / 8, bytes_dev_eager=3 * bw)
    assert m.dominant == "memory" and m.bound_s == pytest.approx(1.0)
    assert m.useful_ratio == pytest.approx(0.5) and m.roofline_fraction == pytest.approx(0.125)


# ------------------------------------------------------- the kernels' work

BF16 = torch.bfloat16


def _valid(n_stages=8, slots=6):
    """chip_smoke.py's pool mask: stage s at phase s, min(s, 6) slots."""
    v = np.zeros((n_stages, slots), bool)
    for s in range(n_stages):
        v[s, :min(s, slots)] = True
    return v


def _k1(h, kvh, d, rows=16, c=512, t=None, **kw):
    t = t or c
    return ("chunk_attention", (meta(rows, c, h, d, dtype=BF16), meta(rows, t, kvh, d, dtype=BF16),
                                meta(rows, t, kvh, d, dtype=BF16)), kw)


def _k2(h, kvh, d):
    return ("pool_attention", (meta(16, 512, h, d, dtype=BF16),
                               meta(6, 16, 512, kvh, d, dtype=BF16),
                               meta(6, 16, 512, kvh, d, dtype=BF16), _valid()), {})


def _k3(h, kvh, d):
    pages = meta(8, 7, 2, 512, kvh, d, dtype=BF16)
    return ("pool_attention_paged", (meta(16, 512, h, d, dtype=BF16), pages, pages, 6,
                                     _valid()), {"ppc": 1})


def _k4(h, p, n):
    return ("ssd", (meta(16, 512, h, p, dtype=BF16), meta(16, 512, h), meta(8, h),
                    meta(16, 512, 1, n, dtype=BF16), meta(16, 512, 1, n, dtype=BF16),
                    meta(8, h), meta(16, h, p, n)), {"chunk": 256})


def _k5(h, kvh, d, s=32768):
    return ("decode_attention", (meta(8, h, d, dtype=BF16), meta(8, s, kvh, d, dtype=BF16),
                                 meta(8, s, kvh, d, dtype=BF16), np.full(8, s)), {})


# (shape, kernel_work's arguments, PERF.md's bound ms, its "by")
PERF_ROWS = [
    ("K1 D 128", _k1(32, 8, 128, return_state=True), 0.0908, "bytes"),
    ("K1 D 112", _k1(32, 32, 112, return_state=True), 0.1058, "bytes"),
    ("K1 D 64 G 4", _k1(32, 8, 64, return_state=True), 0.0457, "bytes"),
    ("K1 GPipe's", _k1(32, 8, 128, rows=8, c=4096), 1.1120, "operations"),
    ("K1 whisper cross", _k1(12, 12, 64, c=56, t=1500, causal_offset=1500), 0.0228, "bytes"),
    ("K1 whisper encoder", _k1(12, 12, 64, rows=2, c=1500, causal_offset=1500), 0.0140,
     "operations"),
    ("K2 D 128", _k2(32, 8, 128), 0.2345, "operations"),
    ("K2 G 5", _k2(40, 8, 128), 0.2931, "operations"),
    ("K3 D 128", _k3(32, 8, 128), 0.2345, "operations"),
    ("K3 D 80 G 1", _k3(32, 32, 80), 0.1466, "operations"),
    ("K4 zamba2-7b", _k4(112, 64, 64), 0.0894, "bytes"),
    ("K4 mamba2-130m", _k4(24, 64, 128), 0.0240, "bytes"),
    ("K5 qwen3-8b", _k5(32, 8, 128), 0.3206, "bytes"),
    ("K5 zamba2-7b", _k5(32, 32, 112), 1.1219, "bytes"),
    ("K5 G 16", _k5(64, 4, 128), 0.1603, "bytes"),
    ("K5 whisper cross", _k5(12, 12, 64, s=1500), 0.0110, "bytes"),
]


@pytest.mark.parametrize("row", PERF_ROWS, ids=[r[0] for r in PERF_ROWS])
def test_kernel_work_gives_the_perf_table_bounds(row):
    _, (tag, args, kw), want_ms, want_by = row
    sec, by = kernel_bound(*kernel_work(tag, *args, **kw))
    assert round(sec * 1e3, 4) == want_ms and by == want_by


def test_kernel_work_counts_only_the_work_the_data_needs():
    q, k = meta(2, 64, 4, 128, dtype=BF16), meta(2, 64, 2, 128, dtype=BF16)
    f_full, b_full, _ = kernel_work("chunk_attention", q, k, k, causal_offset=64)
    f_half, b_half, _ = kernel_work("chunk_attention", q, k, k, causal_offset=64, kv_len=32)
    assert f_half == f_full / 2 and b_half < b_full
    f_causal, _, _ = kernel_work("chunk_attention", q, k, k)
    assert f_causal == 4 * 128 * 2 * 4 * 64 * 65 / 2
    stack = meta(3, 2, 64, 2, 128, dtype=BF16)
    f_one, _, _ = kernel_work("pool_attention", q, stack, stack, np.array([1, 0, 0]))
    f_two, _, _ = kernel_work("pool_attention", q, stack, stack, np.array([1, 0, 1]))
    assert f_two == 2 * f_one
    qd, kd = meta(3, 4, 128, dtype=BF16), meta(3, 100, 2, 128, dtype=BF16)
    f5, b5, _ = kernel_work("decode_attention", qd, kd, kd, np.array([10, 0, 500]))
    assert f5 == 4 * 128 * 4 * 110           # 500 clamps to the cache's 100 keys


# ---------------------------------------------- counting through the kernels

CFG = get_smoke_config("qwen3-8b")
N, M, C, B = 4, 8, 16, 2
COMBOS = [("qship", "cuda", "cuda"), ("fetch", "cuda", "paged"), ("fetch", "cuda", "cuda")]


def _plan(remote, attn, pool):
    return pp.build_plan(CFG, N, M * C, RunConfig(num_chunks=M, num_stages=N, remote_attn=remote,
                                                  attn_backend=attn, pool_backend=pool))


def _count_meta(plan):
    staged = init_staged(CFG, plan, None, device=META)
    tokens = torch.empty((B, M * C), dtype=torch.int64, device=META)
    with torch.no_grad():
        return op_graph.count(lambda st, tk: pp.prefill_pipeline(CFG, st, tk, plan, device=META),
                              staged, tokens)


def _work_of_call(tag, args, kw):
    """``kernel_work`` of one wrapper call, from the call's own tensors."""
    if tag == "chunk_attention":
        q, k, v = args
        return kernel_work(tag, q, k, v, kw.get("k_scale"), kw.get("v_scale"),
                           causal_offset=kw.get("causal_offset", 0), kv_len=kw.get("kv_len"),
                           return_state=kw.get("return_state", False))
    if tag == "pool_attention":
        q, k, v, valid = args
        return kernel_work(tag, q, k, v, valid, kw.get("k_scale"), kw.get("v_scale"),
                           kv_len=kw.get("kv_len"))
    q, kp, vp, handles, valid = args
    return kernel_work(tag, q, kp, vp, torch.as_tensor(handles).numel(), valid,
                       kw.get("k_scale"), kw.get("v_scale"), ppc=kw["ppc"],
                       kv_len=kw.get("kv_len"))


def test_torch_backends_products_equal_flop_counter():
    plan = _plan("qship", "torch", "torch")
    staged = init_staged(CFG, plan, None, device=META)
    tokens = torch.empty((B, M * C), dtype=torch.int64, device=META)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        cost = op_graph.count(lambda st, tk: pp.prefill_pipeline(CFG, st, tk, plan, device=META),
                              staged, tokens)
    assert cost.flops == fc.get_total_flops() > 0
    assert cost.launches == {} and cost.kernel_flops == 0.0


@pytest.mark.parametrize("combo", COMBOS, ids=["/".join(c) for c in COMBOS])
def test_kernel_charges_replace_the_plain_attention(combo, monkeypatch):
    remote, attn, pool = combo
    # a CPU run: every wrapper call (its plain version), with kernel_work of its own tensors
    calls, work = collections.Counter(), collections.defaultdict(lambda: [0.0, 0.0])
    for tag in ("chunk_attention", "pool_attention", "pool_attention_paged"):
        real = getattr(ops, tag)

        def noted(*args, _tag=tag, _real=real, **kw):
            f, b, _ = _work_of_call(_tag, args, kw)
            work[_tag][0] += f
            work[_tag][1] += b
            return _real(*args, **kw)
        monkeypatch.setattr(ops, tag, noted)
    plan = _plan(remote, attn, pool)
    gen = torch.Generator().manual_seed(0)
    staged = init_staged(CFG, plan, gen, device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (B, M * C), generator=gen)
    with torch.no_grad(), ops.timed_launches(device="cpu") as frame:
        pp.prefill_pipeline(CFG, staged, tokens, plan, device="cpu")
    calls.update(tag for tag, _ in frame["events"])
    monkeypatch.undo()

    cost = _count_meta(plan)
    assert cost.launches == dict(calls) and sum(calls.values()) > 0
    for tag, (f, b) in work.items():
        row = cost.by_op[f"kernel:{tag}"]
        assert row["flops"] == pytest.approx(f, rel=1e-12)
        assert row["bytes"] == pytest.approx(b, rel=1e-12)

    # the torch backends' count: its attention products (the plain blocks)
    # are exactly what the kernels' charges take the place of
    attn_flops = [0.0]
    for name in ("self_block", "chunk_block"):
        real = getattr(attention.TorchBackend, name)

        def tallied(self, *args, _real=real, **kw):
            before = op_graph.active().cost.flops
            out = _real(self, *args, **kw)
            attn_flops[0] += op_graph.active().cost.flops - before
            return out
        monkeypatch.setattr(attention.TorchBackend, name, tallied)
    plain = _count_meta(_plan(remote, "torch", "torch"))
    assert attn_flops[0] > 0
    assert cost.product_flops == plain.flops - attn_flops[0]
    assert cost.kernel_flops == pytest.approx(sum(f for f, _ in work.values()), rel=1e-12)


def test_ssd_charges_equal_kernel_work_of_a_cpu_run(monkeypatch):
    cfg = get_smoke_config("mamba2-130m")
    plan = pp.build_plan(cfg, N, M * C, RunConfig(num_chunks=M, num_stages=N, mbkr=False,
                                                  ssm_backend="cuda"))
    # a CPU run: every K4 call (its plain version), with kernel_work of the
    # wrapper's own tensors: a_log / d_skip as [Gs, H], the chunk it runs at
    calls, work = [0], [0.0, 0.0]
    real = ops.ssd

    def noted(x, dt, a_log, b, c, d_skip, *, chunk=128, init_state=None):
        f, nb, _ = kernel_work("ssd", x, dt, a_log if a_log.ndim == 2 else a_log[None], b, c,
                               d_skip if d_skip.ndim == 2 else d_skip[None], init_state,
                               chunk=ops.ssd_chunk(x.shape[1], chunk))
        calls[0] += 1
        work[0] += f
        work[1] += nb
        return real(x, dt, a_log, b, c, d_skip, chunk=chunk, init_state=init_state)
    monkeypatch.setattr(ops, "ssd", noted)
    gen = torch.Generator().manual_seed(0)
    staged = init_staged(cfg, plan, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, M * C), generator=gen)
    with torch.no_grad():
        pp.prefill_pipeline(cfg, staged, tokens, plan, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(ref, "ssd_plain", lambda *a, **k: pytest.fail("a plain version ran"))

    with torch.no_grad():
        cost = op_graph.count(
            lambda st, tk: pp.prefill_pipeline(cfg, st, tk, plan, device=META),
            init_staged(cfg, plan, None, device=META),
            torch.empty((B, M * C), dtype=torch.int64, device=META))
    assert cost.launches == {"ssd": calls[0]} and calls[0] > 0
    row = cost.by_op["kernel:ssd"]
    assert row["flops"] == pytest.approx(work[0], rel=1e-12) and work[0] > 0
    assert row["bytes"] == pytest.approx(work[1], rel=1e-12)
    assert cost.kernel_flops == row["flops"]


def test_a_count_is_its_own_threads():
    import threading
    seen = {}

    def other():
        seen["active"] = op_graph.active()
        seen["host"] = op_graph.host_value(meta(2))

    def fn(x):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["mine"] = op_graph.active()
        return x + 1

    op_graph.count(fn, meta(2))
    assert seen["active"] is None and seen["host"] is None
    assert isinstance(seen["mine"], op_graph.OpCounter) and op_graph.active() is None


def test_meta_branch_runs_no_kernel_and_no_plain_version(monkeypatch):
    for name in ("chunk_attention_plain", "pool_attention_plain", "pool_attention_paged_plain",
                 "ssd_plain", "decode_attention_plain"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail("a plain version ran"))
    ops.reset_launches()
    q, k = meta(2, 16, 4, 128, dtype=BF16), meta(2, 16, 2, 128, dtype=BF16)

    def fn(q, k):
        out, m, l, acc = ops.chunk_attention(q, k, k, return_state=True)
        valid = torch.as_tensor(np.array([[True, False]]), device=META)
        st = ops.pool_attention(q, k[None].expand(2, -1, -1, -1, -1).contiguous(),
                                k[None].expand(2, -1, -1, -1, -1).contiguous(), valid)
        lens = torch.full((2,), 9, dtype=torch.int32, device=META)
        dec = ops.decode_attention(q[:, 0].contiguous(), k, k, lens)
        return out, m, l, acc, st, dec

    cost = op_graph.count(fn, q, k)
    out, m, l, acc, (pm, pl, pacc), dec = cost.result
    assert out.shape == q.shape and out.dtype == BF16
    assert m.shape == l.shape == (2, 4, 16) and acc.shape == (2, 16, 4, 128)
    assert acc.dtype == pm.dtype == torch.float32 and pacc.shape == acc.shape
    assert dec.shape == (2, 4, 128) and dec.device.type == "meta"
    assert cost.launches == {"chunk_attention": 1, "pool_attention": 1, "decode_attention": 1}
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="several devices"):
        ops.chunk_attention(q, torch.zeros(k.shape, dtype=BF16), k)


def test_k2_mask_without_host_values_raises():
    q, k = meta(2, 16, 4, 128, dtype=BF16), meta(2, 2, 16, 2, 128, dtype=BF16)

    def fn(q, k):
        valid = torch.empty((1, 2), dtype=torch.bool, device=META)   # no host data
        return ops.pool_attention(q, k, k, valid)

    with pytest.raises(ValueError, match="no recorded host"):
        op_graph.count(fn, q, k)
    # outside a count the meta branch needs no values: shapes only
    assert fn(q, k)[2].shape == (2, 16, 4, 128)
