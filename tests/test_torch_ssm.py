"""The port's Mamba2 pieces against the JAX reference on the CPU, float32,
same numpy inputs: the plain version of the SSD scan K4
(``repro_torch.kernels.ref.ssd_plain``, which ``kernels.ops.ssd`` takes on
the CPU) against the reference Pallas kernel in interpret mode
(``repro.kernels.ops.ssd``), the sequential oracle ``ref.ssd_ref`` and the
chunked ``models.ssm.ssd_chunked``; the port's own ``ssd_chunked``; K4's
tensor-core tile algorithm emulated on the CPU against ``ssd_plain`` and
the Pallas kernel; strided views of the conv output through ``ops.ssd``;
the causal conv, the block with and without carried state, whole-model
forwards of the smoke mamba2-130m and zamba2-7b, and the bridge's fp32
leaves.

Tolerances: the SSD outputs y and the final state each within 1e-5 of their
own max|ref| (fp32; the gap is summation order); the tile algorithm's state
within 1e-5 and its y (bf16 operands on the y side) within 5e-3; blocks
1e-5; forwards max rel < 2e-3 (denominator floor 1e-3), the bound of
``tests/helpers/pipeline_check.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_k
from repro.models import ssm as RS
from repro.models.api import build_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config, replace
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as S


def _inputs(r, t, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((r, t, h)))).astype(np.float32)  # softplus
    b = rng.standard_normal((r, t, g, n)).astype(np.float32)
    c = rng.standard_normal((r, t, g, n)).astype(np.float32)
    init = (0.5 * rng.standard_normal((r, h, p, n))).astype(np.float32)
    return x, dt, b, c, init


def _heads(h, gs=1, seed=0):
    """a_log and d_skip [Gs, H]: log(1..H) as the reference's init, shifted
    per stage group so that every group has its own layer."""
    rng = np.random.default_rng(seed + 100)
    a = np.log(np.arange(1, h + 1, dtype=np.float32))[None] + \
        0.3 * rng.standard_normal((gs, h)).astype(np.float32)
    d = (1.0 + 0.5 * rng.standard_normal((gs, h))).astype(np.float32)
    return a, d


def _held(got, want, rel=1e-5):
    """Each output at its own scale: max abs err <= rel * max|want|."""
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= rel * scale, (err, scale)


T_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731


# ------------------------------------------------------------------ K4

SSD_GRID = [   # (rows, T, H, P, G, N, chunk): tests/test_kernels.py::test_ssd
    (2, 64, 4, 8, 1, 16, 16),
    (1, 128, 2, 16, 2, 8, 32),
    (1, 96, 4, 8, 4, 8, 32),
    (2, 48, 4, 8, 2, 8, 32),   # T not a multiple of the chunk: 32 -> 16
    (2, 16, 4, 16, 1, 16, 32),  # T < chunk (the smoke pipeline's C = 16)
]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("r,t,h,p,g,n,ck", SSD_GRID)
def test_ssd_plain_matches_reference(r, t, h, p, g, n, ck, init):
    x, dt, b, c, st0 = _inputs(r, t, h, p, g, n)
    a, d = _heads(h)
    a, d = a[0], d[0]
    st0 = st0 if init else None
    got = ops.ssd(T_(x), T_(dt), T_(a), T_(b), T_(c), T_(d), chunk=ck,
                  init_state=None if st0 is None else T_(st0))
    assert ops.LAUNCHES["ssd"] == 0            # the CPU never launches
    jin = [jnp.asarray(v) for v in (x, dt, a, b, c, d)]
    jst = None if st0 is None else jnp.asarray(st0)
    _held(got, ref_ops.ssd(*jin, chunk=ck, init_state=jst))    # Pallas, interpret
    _held(got, ref_k.ssd_ref(*jin, init_state=jst))
    _held(got, RS.ssd_chunked(*jin, chunk=ck, init_state=jst))
    # the port's torch backend (the "minimal" algorithm)
    _held(S.ssd_chunked(T_(x), T_(dt), T_(a), T_(b), T_(c), T_(d), chunk=ck,
                        init_state=None if st0 is None else T_(st0)),
          RS.ssd_chunked(*jin, chunk=ck, init_state=jst))


def test_chunk_rule_is_the_reference_rule():
    assert [ops.ssd_chunk(t, 32) for t in (16, 32, 48, 96, 100, 512)] == \
        [16, 32, 16, 32, 4, 32]
    assert ops.ssd_chunk(512, 256) == 256


@pytest.mark.parametrize("impl", ["plain", "chunked"])
def test_ssd_stage_groups(impl):
    """Gs = 4 stage groups of 2 rows, each with its own a_log / d_skip:
    equal to one reference call per group."""
    gs, per, t, h, p, g, n, ck = 4, 2, 32, 4, 8, 2, 8, 16
    x, dt, b, c, st0 = _inputs(gs * per, t, h, p, g, n, seed=3)
    a, d = _heads(h, gs, seed=3)
    fn = ops.ssd if impl == "plain" else S.ssd_chunked
    y, st = fn(T_(x), T_(dt), T_(a), T_(b), T_(c), T_(d), chunk=ck, init_state=T_(st0))
    for k in range(gs):
        rows = slice(k * per, (k + 1) * per)
        want = ref_ops.ssd(*(jnp.asarray(v[rows]) for v in (x, dt)),
                           jnp.asarray(a[k]), jnp.asarray(b[rows]),
                           jnp.asarray(c[rows]), jnp.asarray(d[k]), chunk=ck,
                           init_state=jnp.asarray(st0[rows]))
        _held((y[rows], st[rows]), want)


def test_ssd_state_carry():
    """Two calls with the state carried == one long call
    (tests/test_kernels.py::test_ssd_state_carry)."""
    x, dt, b, c, _ = _inputs(1, 64, 2, 8, 1, 8, seed=5)
    a, d = _heads(2)
    a, d = T_(a[0]), T_(d[0])
    x, dt, b, c = map(T_, (x, dt, b, c))
    y_full, st_full = ops.ssd(x, dt, a, b, c, d, chunk=16)
    _, st1 = ops.ssd(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32], d, chunk=16)
    y2, st2 = ops.ssd(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:], d, chunk=16,
                      init_state=st1)
    _held((y2, st2), (y_full[:, 32:].numpy(), st_full.numpy()))


def test_ssd_refuses_bad_shapes():
    x, dt, b, c, _ = _inputs(2, 16, 4, 8, 2, 8)
    a, d = _heads(4, 3)
    with pytest.raises(ValueError):     # 3 stage groups do not divide 2 rows
        ops.ssd(T_(x), T_(dt), T_(a), T_(b), T_(c), T_(d), chunk=16)
    with pytest.raises(ValueError):
        ops.ssd(T_(x), T_(dt[:, :8]), T_(a[0]), T_(b), T_(c), T_(d[0]), chunk=16)


# ------------------------------------------ K4's tensor-core tile algorithm

LOG2E = 1.4426950408889634
TC_CHUNK, TC_TILE = 256, 64


def _bf16(t):
    return t.bfloat16().float()


def _warp_scan(v):
    """Inclusive scan of v [..., 256] in ``ssd_tc_kernel``'s order: by
    shuffles (Hillis-Steele) within each warp of 32 positions, then the warp
    totals added in order. Returns (the scan, the chunk's total)."""
    w = v.reshape(*v.shape[:-1], TC_CHUNK // 32, 32)
    for off in (1, 2, 4, 8, 16):
        w = torch.cat([w[..., :off], w[..., off:] + w[..., :-off]], dim=-1)
    tot, pre = torch.zeros_like(w[..., 0, 0]), []
    for k in range(TC_CHUNK // 32):
        pre.append(tot)
        tot = tot + w[..., k, 31]
    return (w + torch.stack(pre, -1)[..., None]).reshape(v.shape), tot


def _tile_emulation(x, dt, a_log, b, c, d_skip, init_state=None, *, split=True):
    """K4's tensor-core body (``ssd_tc_kernel`` in ``csrc/ssd.cu``) on the
    CPU, in its order and with its bf16 roundings. Per chunk of 256: cs =
    the warp-shuffle scan of dt A in log2 units; per 64-row query tile i,
    Y = 2^cs_i C_i.bf16(S)^T + d x_i, then for each key tile j <= i (10 of
    the 16 pairs) the scores C_i.B_j^T, masked (j > i, diagonal tile) before
    the exponential, P = bf16(scores 2^(cs_i - cs_j) dt_j), Y += P.x_j;
    then S = S 2^cs_last + x^T.(hi + lo), hi = bf16(w o B), lo = bf16(w o B
    - hi), w = 2^(cs_last - cs) dt (``split=False``: x^T.hi, one bf16
    rounding). x, b and c hold bf16 values. Returns (y [R,T,H,P] fp32, the
    accumulator the kernel rounds to bf16 as it stores it; the state
    [R,H,P,N] fp32)."""
    r, t, h, p = x.shape
    g, n = b.shape[2:]
    a2 = -torch.exp(port_ref.per_row(a_log, r)) * LOG2E          # [R,H]
    dsk = port_ref.per_row(d_skip, r)[:, :, None, None]
    st = torch.zeros((r, h, p, n)) if init_state is None else init_state.clone()
    xs = x.permute(0, 2, 1, 3)                                   # [R,H,T,P]
    bs = b.repeat_interleave(h // g, 2).permute(0, 2, 1, 3)      # [R,H,T,N]
    cs_ = c.repeat_interleave(h // g, 2).permute(0, 2, 1, 3)
    dts = dt.permute(0, 2, 1)                                    # [R,H,T]
    tri = torch.ones((TC_TILE, TC_TILE), dtype=torch.bool).tril()
    tiles = lambda c0, i: slice(c0 + TC_TILE * i, c0 + TC_TILE * (i + 1))   # noqa: E731
    ys = []
    for c0 in range(0, t, TC_CHUNK):
        d = dts[..., c0:c0 + TC_CHUNK]
        cs, last = _warp_scan(d * a2[..., None])
        loc = lambda i: slice(TC_TILE * i, TC_TILE * (i + 1))   # noqa: E731
        sbf = _bf16(st)
        yc = []
        for i in range(TC_CHUNK // TC_TILE):
            ci, csi = cs_[:, :, tiles(c0, i)], cs[..., loc(i)]
            y = (ci @ sbf.transpose(-1, -2)) * torch.exp2(csi)[..., None] \
                + dsk * xs[:, :, tiles(c0, i)]
            for j in range(i + 1):
                s = ci @ bs[:, :, tiles(c0, j)].transpose(-1, -2)
                dl = csi[..., :, None] - cs[..., None, loc(j)]
                if j == i:
                    dl = dl.masked_fill(~tri, float("-inf"))
                pm = _bf16(s * torch.exp2(dl) * d[..., None, loc(j)])
                y = y + pm @ xs[:, :, tiles(c0, j)]
            yc.append(y)
        ys.append(torch.cat(yc, 2))
        wb = (torch.exp2(last[..., None] - cs) * d)[..., None] * bs[:, :, c0:c0 + TC_CHUNK]
        hi = _bf16(wb)
        xt = xs[:, :, c0:c0 + TC_CHUNK].transpose(-1, -2)
        upd = xt @ hi + xt @ _bf16(wb - hi) if split else xt @ hi
        st = st * torch.exp2(last)[..., None, None] + upd
    return torch.cat(ys, 2).permute(0, 2, 1, 3), st


def _serve_inputs(r, t, h, p, g, n, init, seed=0):
    """SSD inputs with the serve path's distributions (``chip_smoke.
    ssd_inputs``), made with numpy: dt log-uniform in [1e-3, 1e-1] per head
    times a log-normal factor, a_log = log(1..H) + noise, d_skip near 1, x,
    B and C unit normal rounded to bf16, init_state 0.1 x normal."""
    rng = np.random.default_rng(seed)
    u = rng.random(h)
    dt_head = np.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt = dt_head * np.exp(0.5 * rng.standard_normal((r, t, h)))
    a_log = np.log(np.arange(1, h + 1)) + 0.1 * rng.standard_normal(h)
    d_skip = 1.0 + 0.1 * rng.standard_normal(h)
    x = rng.standard_normal((r, t, h, p))
    b, c = rng.standard_normal((r, t, g, n)), rng.standard_normal((r, t, g, n))
    st0 = 0.1 * rng.standard_normal((r, h, p, n)) if init else None
    f32 = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32))  # noqa
    return (_bf16(f32(x)), f32(dt), f32(a_log), _bf16(f32(b)), _bf16(f32(c)),
            f32(d_skip), f32(st0))


# (P, N): zamba2-7b's and mamba2-130m's heads; 4 heads, 2 rows, two chunks;
# with and without init_state, G = 1 as at both serve shapes and G = 2; and
# without the hi / lo split, which must miss the card's 1e-3 state check
TC_CASES = [(p, n, 1, init, True) for p, n in ((64, 64), (64, 128)) for init in (False, True)] \
    + [(64, 64, 2, True, True), (64, 64, 1, True, False), (64, 128, 1, False, False)]


@pytest.mark.parametrize("p,n,g,init,split", TC_CASES)
def test_k4_tile_algorithm_matches_plain(p, n, g, init, split):
    """K4's tensor-core tile algorithm against ``ssd_plain`` on the same
    bf16-valued inputs: the state within 1e-5 of max|state| (100x inside
    the card's 1e-3 check) and y within 5e-3 of max|y| (4x inside its
    2e-2). Without the hi / lo split of w o B the state is off by more than
    1e-3 of max|state|: the split is what keeps K4 inside the check."""
    *args, st0 = _serve_inputs(2, 2 * TC_CHUNK, 4, p, g, n, init)
    y, st = _tile_emulation(*args, init_state=st0, split=split)
    y_want, st_want = port_ref.ssd_plain(*args, chunk=TC_CHUNK, init_state=st0)
    st_err = (st - st_want).abs().max().item() / st_want.abs().max().item()
    if not split:
        assert st_err > 1e-3, st_err
        return
    assert st_err <= 1e-5, st_err
    assert (y - y_want).abs().max().item() <= 5e-3 * y_want.abs().max().item()


def test_k4_tile_algorithm_matches_pallas():
    """The same emulation against the reference Pallas SSD kernel
    (interpret mode) at a small size: one row, two heads, two chunks of
    256, zamba2-7b's head (P 64, N 64), an init_state."""
    *args, st0 = _serve_inputs(1, 2 * TC_CHUNK, 2, 64, 1, 64, True, seed=1)
    got = _tile_emulation(*args, init_state=st0)
    want = ref_ops.ssd(*(jnp.asarray(v.numpy()) for v in args), chunk=TC_CHUNK,
                       init_state=jnp.asarray(st0.numpy()))
    for g, w, rel in zip(got, want, (5e-3, 1e-5)):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= rel * np.abs(w).max()


def _conv_views(r, t, h, p, g, n, dtype, seed=0):
    """x [R,T,H,P], b and c [R,T,G,N] as the Mamba2 block hands them to
    K4: views into one conv output [R, T, H P + 2 G N]."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((r, t, h * p + 2 * g * n)).astype(np.float32))
    xbc = xbc.to(dtype)
    x, b, c = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    return x.view(r, t, h, p), b.view(r, t, g, n), c.view(r, t, g, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_takes_strided_views(dtype):
    """``ops.ssd`` on the conv output's strided views equals it on dense
    copies, and ``ops.ssd_strides`` takes those views as they are (the
    strides K4 reads them at on the card)."""
    r, t, h, p, g, n = 2, 64, 4, 16, 1, 16
    x, b, c = _conv_views(r, t, h, p, g, n, dtype)
    assert not x.is_contiguous() and not b.is_contiguous()
    _, dt, _, _, _ = _inputs(r, t, h, p, g, n, seed=4)
    a, d = _heads(h)
    a, d = T_(a[0]), T_(d[0])
    got = ops.ssd(x, T_(dt), a, b, c, d, chunk=32)
    want = ops.ssd(x.contiguous(), T_(dt), a, b.contiguous(), c.contiguous(), d, chunk=32)
    for gv, wv in zip(got, want):
        assert torch.equal(gv, wv)
    conv = h * p + 2 * g * n
    assert ops.ssd_strides(x) == (t * conv, conv)
    assert ops.ssd_strides(c) == (t * conv, conv)


def test_ssd_strides_refuses_other_layouts():
    """K4 takes a position's heads and the last dim dense and 16-byte rows;
    a transposed view, a strided last dim or an odd position stride raise."""
    x = torch.zeros((2, 8, 4, 16), dtype=torch.bfloat16)
    assert ops.ssd_strides(x) == (8 * 64, 64)
    odd_rows = torch.zeros((2, 8, 68), dtype=torch.bfloat16)[..., :64].view(2, 8, 4, 16)
    for bad in (x.transpose(2, 3), x[..., ::2], odd_rows):
        with pytest.raises(ValueError):
            ops.ssd_strides(bad)


# ------------------------------------------------------------ the block

def _mamba_cfgs():
    rcfg = ref_replace(ref_smoke("mamba2-130m"), dtype="float32")
    return rcfg, replace(get_smoke_config("mamba2-130m"), dtype="float32")


def _ref_params(rcfg):
    return jax.tree.map(np.asarray, build_model(rcfg).init(jax.random.key(0)))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    got = S.causal_conv(T_(x), T_(w), T_(bias), init_state=None if st is None else T_(st))
    want = RS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                          init_state=None if st is None else jnp.asarray(st))
    _held(got, want)
    # per-row weights (the stage-stacked form) equal one call per row
    w2 = np.stack([w, 2 * w])
    got2 = S.causal_conv(T_(x), T_(w2), T_(np.stack([bias, bias])),
                         init_state=None if st is None else T_(st))
    _held((got2[0][1:],), (2 * got[0][1:] - T_(bias),))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_block_apply_matches_reference(impl):
    """One Mamba2 block (layer 1 of the smoke config) with and without a
    carried state, through each SSD backend (``cuda`` takes K4's plain
    version on the CPU)."""
    rcfg, cfg = _mamba_cfgs()
    tree = _ref_params(rcfg)
    lp_np = {k: v[1] for k, v in tree["layers"].items()}
    lp = bridge.params_from_numpy(lp_np, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(jnp.asarray, lp_np)
    y_r, st_r = RS.block_apply(rcfg, jlp, jnp.asarray(x))
    y, st = S.block_apply(cfg, lp, T_(x), ssd_impl=impl)
    _held((y, st["conv"], st["ssd"]), (y_r, st_r["conv"], st_r["ssd"]))
    y_r2, st_r2 = RS.block_apply(rcfg, jlp, jnp.asarray(x), state=st_r)
    y2, st2 = S.block_apply(cfg, lp, T_(x), state=st, ssd_impl=impl)
    _held((y2, st2["conv"], st2["ssd"]), (y_r2, st_r2["conv"], st_r2["ssd"]))
    with pytest.raises(KeyError, match="unknown ssm backend"):
        S.block_apply(cfg, lp, T_(x), ssd_impl="nope")


def test_block_apply_stage_stacked_equals_per_stage():
    """Stage-stacked weights [N, ...] over x [N, B, T, d] equal N one-layer
    calls: the stage axis folds into the scan's rows with one a_log row per
    stage."""
    rcfg, cfg = _mamba_cfgs()
    tree = bridge.params_from_numpy(_ref_params(rcfg)["layers"], device="cpu")
    x = T_(np.random.default_rng(4).standard_normal((2, 2, 24, cfg.d_model)).astype(np.float32))
    y, st = S.block_apply(cfg, tree, x, ssd_impl="cuda")
    for i in range(2):
        yi, sti = S.block_apply(cfg, {k: w[i] for k, w in tree.items()}, x[i])
        _held((y[i], st["ssd"][i], st["conv"][i]),
              (yi.numpy(), sti["ssd"].numpy(), sti["conv"].numpy()))


# ------------------------------------------------------------ forwards

@pytest.mark.parametrize("arch,impl", [("mamba2-130m", "torch"), ("mamba2-130m", "cuda"),
                                       ("zamba2-7b", "torch"), ("zamba2-7b", "cuda")])
def test_forward_matches_reference(arch, impl):
    rcfg = ref_replace(ref_smoke(arch), dtype="float32")
    cfg = replace(get_smoke_config(arch), dtype="float32")
    tree = _ref_params(rcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    want = np.asarray(build_model(rcfg).forward(jax.tree.map(jnp.asarray, tree),
                                                jnp.asarray(toks)))
    params = bridge.params_from_numpy(tree, device="cpu")
    fwd = S.forward if arch == "mamba2-130m" else HY.forward
    got = fwd(cfg, params, torch.from_numpy(toks), ssd_impl=impl).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 2e-3, rel.max()


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_init_shapes_and_dtypes_match_reference(arch):
    """The port's ``init`` draws the reference's tree: same keys and
    shapes, the same fp32 leaves under a bf16 model, stds within 15 %."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    tree = _ref_params(rcfg)
    p = (S.init if arch == "mamba2-130m" else HY.init)(
        cfg, torch.Generator().manual_seed(0), "cpu")
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): v   # noqa: E731
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(tree), {k: v for k, v in flat(p).items()}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert (g.dtype == torch.float32) == (w.dtype == np.float32), name
        ws = np.asarray(w, np.float32).std()
        if ws > 0 and name.split("/")[-1] != "dt_bias":
            assert abs(g.float().std().item() / ws - 1) < 0.15, name


def test_bridge_keeps_ssm_scalars_fp32():
    """Under dtype=bfloat16 the bridge recasts the weights but keeps
    a_log, dt_bias and d_skip in fp32, as the reference does."""
    tree = _ref_params(ref_replace(ref_smoke("zamba2-7b"), dtype="float32"))
    params = bridge.params_from_numpy(tree, device="cpu", dtype="bfloat16")
    for part in ("mamba_groups", "mamba_tail"):
        for k, v in params[part].items():
            want = torch.float32 if k in S.FP32_PARAMS else torch.bfloat16
            assert v.dtype == want, (part, k)
    assert params["shared"]["wq"].dtype == torch.bfloat16
