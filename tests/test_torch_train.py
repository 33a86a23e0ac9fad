"""The port's training path against the JAX reference on the CPU, fp32:

- ``train.optim`` (AdamW with clipping and decoupled weight decay, the
  cosine LR) against ``repro.train.optim`` on the same numpy trees over
  three steps: params, moments, grad norm and LR at rtol 1e-6;
- ``Model.loss`` against ``model.loss`` (rel 1e-5) and every gradient
  leaf against ``jax.grad`` (within 1e-4 of that leaf's max|g|) for the
  smoke configs of the six families (qwen3-8b dense, qwen2-moe-a2.7b moe,
  mamba2-130m ssm, zamba2-7b hybrid, llava-next-34b vlm with patch
  embeddings, whisper-small encdec with frame embeddings); qwen3-8b at
  1100 positions, where the attention takes two key blocks of 1024;
- one ``make_train_step`` at ``grad_accum`` 1 and 4 against the
  reference's (jitted, remat off): loss at rel 1e-5, the new params at
  atol 2e-5. A first AdamW step moves an element by about lr * sign(g),
  so an element whose reference gradient lies within the measured
  gradient difference of zero may step either way: those are held at
  2 lr + 2e-5 instead, and the test counts and prints them (0 of the
  106880 here at grad_accum 1 and 4; it fails above 0.1 %);
- remat against no remat (loss rel 1e-6) and the reference's
  loss-decrease run on stablelm-3b;
- the no-backward guard of K1-K5 and the differentiable ``moe_layer``,
  equal (``torch.equal``) to its former ``matmul(out=)`` path."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models.api import build_model as ref_build
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch import bridge
from repro_torch.configs import get_smoke_config, replace
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.train import optim as O
from repro_torch.train.step import init_train_state, make_train_step
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ("qwen3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-7b",
            "llava-next-34b", "whisper-small")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _close(got: torch.Tensor, want, rtol: float, what: str) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max() if want.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


# ------------------------------------------------------------------ optim

OPT_CASES = {   # AdamWConfig, and the grads' scale (1: below the clip, 100: clipped)
    "warmup_clipped": (dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0), 100.0),
    "cosine_unclipped": (dict(lr=1e-2, b2=0.99, warmup_steps=0, total_steps=3,
                              grad_clip=1e9, min_lr_frac=0.3), 1.0),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_reference(case):
    """Three steps on a tree with a matrix, a stacked [L, d] norm (decayed:
    ndim 2) and a 1-D bias (not decayed), bf16 and fp32 leaves: params,
    m, v, step, grad norm and LR at rtol 1e-6."""
    kw, scale = OPT_CASES[case]
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "layers": {"ln": rng.standard_normal((2, 6)).astype(np.float32),
                    "b": rng.standard_normal((6,)).astype(np.float32)}}
    rcfg, cfg = RO.AdamWConfig(**kw), O.AdamWConfig(**kw)
    rp, rst = jax.tree.map(jnp.asarray, p), RO.adamw_init(jax.tree.map(jnp.asarray, p))
    tp = _t(p)
    tst = O.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * scale, p)
        rp, rst, rm = RO.adamw_update(rcfg, jax.tree.map(jnp.asarray, g), rst, rp)
        tp, tst, tm = O.adamw_update(cfg, _t(g), tst, tp)
        for got, want in zip(O.leaves(tp) + O.leaves(tst["m"]) + O.leaves(tst["v"]),
                             jax.tree.leaves(rp) + jax.tree.leaves(rst["m"])
                             + jax.tree.leaves(rst["v"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
        assert int(tst["step"]) == int(rst["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-6)


def test_cosine_lr_and_clip_match_reference():
    """The schedule at every step of warmup, decay and past the end, and
    the clip's grad norm (the reference's own cases)."""
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    for s in range(0, 125):
        want = float(RO.cosine_lr(RO.AdamWConfig(**cfg), jnp.int32(s)))
        got = float(O.cosine_lr(O.AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6), s
    p = {"w": torch.ones((4,))}
    _, _, m = O.adamw_update(O.AdamWConfig(grad_clip=0.1, warmup_steps=0, total_steps=10),
                             {"w": torch.full((4,), 100.0)}, O.adamw_init(p), p)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


# ------------------------------------------------------------ loss / grads

def _inputs(rcfg, b: int, s: int):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    embeds = None
    if rcfg.frontend.kind != "none" or rcfg.family == "encdec":
        nf = rcfg.frontend.num_embeds or 16
        embeds = (rng.standard_normal((b, nf, rcfg.d_model)) * 0.02).astype(np.float32)
    return toks, labels, embeds


# qwen3-8b at 1100 positions: its attention takes two key blocks of 1024
LOSS_CASES = {arch: (arch, 1100 if arch == "qwen3-8b" else 24) for arch in FAMILIES}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    arch, s = LOSS_CASES[case]
    rcfg = ref_replace(ref_smoke(arch), dtype="float32")
    cfg = replace(get_smoke_config(arch), dtype="float32")
    rm, pm = ref_build(rcfg), build_model(cfg)
    tree = _np(jax.jit(rm.init)(jax.random.key(0)))
    toks, labels, embeds = _inputs(rcfg, 2, s)
    kw = {} if embeds is None else {"embeds": jnp.asarray(embeds)}
    want, wgrads = jax.jit(jax.value_and_grad(      # remat changes no value, only compile time
        lambda p: rm.loss(p, jnp.asarray(toks), jnp.asarray(labels), remat=False, **kw)))(
        jax.tree.map(jnp.asarray, tree))
    params = O.tree_map(lambda t: t.requires_grad_(True), _t(tree))
    tkw = {} if embeds is None else {"embeds": torch.from_numpy(embeds)}
    loss = pm.loss(params, torch.from_numpy(toks), torch.from_numpy(labels), **tkw)
    grads = torch.autograd.grad(loss, O.leaves(params))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    wleaves = jax.tree.leaves(wgrads)
    assert len(wleaves) == len(grads)
    for g, w in zip(grads, wleaves):
        assert g.shape == w.shape
        _close(g, w, 1e-4, case)


# -------------------------------------------------------------- train step

def _ref_state(rcfg, seed: int = 0):
    model = ref_build(rcfg)
    return model, jax.jit(lambda key: RS.init_train_state(model, key))(jax.random.key(seed))


@pytest.mark.parametrize("grad_accum", [1, 4])
def test_train_step_matches_reference(grad_accum):
    rcfg = ref_replace(ref_smoke("qwen3-8b"), dtype="float32")
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    rmodel, rstate = _ref_state(rcfg)
    data = RefSyntheticLM(cfg.vocab_size, 32, 8, seed=5)
    nb = data.next_batch()
    ropt, opt = (RO.AdamWConfig(warmup_steps=0, total_steps=10),
                 O.AdamWConfig(warmup_steps=0, total_steps=10))
    r_new, r_met = jax.jit(RS.make_train_step(rmodel, None, ropt, grad_accum=grad_accum,
                                              remat=False))(
        rstate, {k: jnp.asarray(v) for k, v in nb.items()})
    state = bridge.train_state_from_numpy(_np(rstate), device="cpu")
    tparams = O.tree_map(lambda t: t.clone().requires_grad_(True), state["params"])
    loss = build_model(cfg).loss(tparams, *(torch.from_numpy(nb[k]) for k in ("tokens",
                                                                               "labels")))
    tgrads = torch.autograd.grad(loss, O.leaves(tparams))
    wgrads = jax.tree.leaves(jax.jit(jax.grad(lambda p: rmodel.loss(
        p, jnp.asarray(nb["tokens"]), jnp.asarray(nb["labels"]), remat=False)))(
        rstate["params"]))
    new, met = make_train_step(build_model(cfg), opt, grad_accum=grad_accum, remat=False)(
        state, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert float(met["loss"]) == pytest.approx(float(r_met["loss"]), rel=1e-5)
    assert float(met["lr"]) == pytest.approx(float(r_met["lr"]), rel=1e-6)
    assert float(met["grad_norm"]) == pytest.approx(float(r_met["grad_norm"]), rel=1e-4)
    lr = float(r_met["lr"])
    loose = total = 0
    for got, want, tg, wg in zip(O.leaves(new["params"]), jax.tree.leaves(r_new["params"]),
                                 tgrads, wgrads):
        wg = np.asarray(wg)
        near_zero = np.abs(wg) < np.abs(tg.numpy() - wg)     # the sign may differ
        tol = np.where(near_zero, 2 * lr + 2e-5, 2e-5)
        assert (np.abs(got.numpy() - np.asarray(want)) <= tol).all()
        loose += int(near_zero.sum())
        total += wg.size
    print(f"grad_accum {grad_accum}: {loose} of {total} elements held at 2 lr")
    assert loose < total // 1000, (loose, total)
    assert int(new["opt"]["step"]) == int(r_new["opt"]["step"]) == 1


def test_remat_matches_no_remat():
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
    nb = SyntheticLM(cfg.vocab_size, 32, 4, seed=7).next_batch()
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    opt = O.AdamWConfig(warmup_steps=0, total_steps=10)
    s1, m1 = make_train_step(model, opt, remat=False)(copy.deepcopy(state), batch)
    s2, m2 = make_train_step(model, opt, remat=True)(copy.deepcopy(state), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    for a, b in zip(O.leaves(s1["params"]), O.leaves(s2["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_loss_decreases_end_to_end():
    """The reference's run (stablelm-3b smoke, fp32, 40 steps of 8 x 64)."""
    cfg = replace(get_smoke_config("stablelm-3b"), dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(1), device="cpu")
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=2)
    step = make_train_step(model, O.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40),
                           remat=False)
    losses = []
    for _ in range(40):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in data.next_batch().items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert all(np.isfinite(losses))


# --------------------------------------------------------- grad guard, MoE

def _kernel_calls(t):
    q = t(2, 8, 4, 16)
    k, v = t(2, 8, 2, 16), t(2, 8, 2, 16)
    st = t(3, 2, 8, 2, 16)
    pages = t(4, 2, 8, 2, 16)
    valid = torch.ones(3, dtype=torch.bool)
    x, bc = t(2, 16, 4, 16), t(2, 16, 1, 16)
    return {
        "chunk_attention": lambda: ops.chunk_attention(q, k, v),
        "pool_attention": lambda: ops.pool_attention(q, st, st, valid),
        "pool_attention_paged": lambda: ops.pool_attention_paged(
            q, pages, pages, torch.arange(3, dtype=torch.int32), valid, ppc=1),
        "ssd": lambda: ops.ssd(x, t(2, 16, 4).abs(), t(4), bc, bc, t(4), chunk=8),
        "decode_attention": lambda: ops.decode_attention(
            t(2, 4, 16), k, v, torch.full((2,), 8, dtype=torch.int32)),
    }


@pytest.mark.parametrize("kernel", list(ops.LAUNCHES))
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """K1-K5 have no backward: with grad enabled, an input that requires
    grad raises (here on the CPU, before the plain version; on the card
    before the launch); under ``torch.no_grad`` the same call runs."""
    gen = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(True)
    calls = _kernel_calls(t)
    with pytest.raises(RuntimeError, match="no backward"):
        calls[kernel]()
    with torch.no_grad():
        calls[kernel]()


def _moe_layer_with_out(params, x, *, num_experts, top_k, capacity_factor, num_real=0,
                        sharded=False, ep=False):
    """``layers.moe_layer`` as it was before it became differentiable: the
    expert products written with ``torch.matmul(..., out=)`` into slices
    of one ``new_empty`` buffer."""
    grouped = params["router"].ndim == 3
    if not grouped:
        params = {n: w[None] for n, w in params.items()}
        x = x[None]
    g, b, s, d = x.shape
    e, k = num_experts, top_k
    cap = L.moe_capacity(s, k, num_real or e, capacity_factor)
    weights, choices = L.moe_route(x.reshape(g, b * s, d), params["router"], top_k=k,
                                   num_real=num_real)
    tok, valid, wgt, pos = L.moe_dispatch(choices.reshape(g * b, s, k),
                                          weights.reshape(g * b, s, k), e, cap)
    xr = x.reshape(g * b, s, d)
    xd = xr.gather(1, tok.reshape(g * b, e * cap, 1).long().expand(-1, -1, d))
    xd = xd * valid.reshape(g * b, e * cap, 1).to(x.dtype)
    xd = xd.reshape(g, b, e, cap, d).transpose(1, 2).reshape(g, e, b * cap, d)

    def experts(xs, wg, wu, wd, out):
        h = torch.nn.functional.silu(torch.matmul(xs, wg)) * torch.matmul(xs, wu)
        torch.matmul(h, wd, out=out)

    def pairs_of(y):
        y = y.reshape(g, e, b, cap, d).transpose(1, 2).reshape(g * b, e * cap, d)
        y = y * (wgt * valid).reshape(g * b, e * cap, 1).to(y.dtype)
        kept = pos < e * cap
        pairs = y.gather(1, torch.where(kept, pos, 0)[..., None].expand(-1, -1, d))
        return torch.where(kept[..., None], pairs, 0).reshape(g, b, s, k, d)

    if not sharded:
        y = xd.new_empty((g, e, b * cap, d))
        for i in range(g):
            experts(xd[i], params["wg"][i], params["wu"][i], params["wd"][i], y[i])
        out = pairs_of(y).float().sum(3).to(x.dtype)
        return out if grouped else out[0]
    shards = params["wg"].shape[1]
    if ep:
        e_loc = e // shards
        y = xd.new_empty((g, e, b * cap, d))
        for i in range(g):
            for t in range(shards):
                rows = slice(t * e_loc, (t + 1) * e_loc)
                experts(xd[i, rows], params["wg"][i, t], params["wu"][i, t],
                        params["wd"][i, t], y[i, rows])
        pairs = pairs_of(y)
        owner = (choices.reshape(g, b, s, k) // e_loc)[..., None]
        parts = [torch.where(owner == t, pairs, 0).float().sum(3) for t in range(shards)]
    else:
        parts = []
        for t in range(shards):
            y = xd.new_empty((g, e, b * cap, d))
            for i in range(g):
                experts(xd[i], params["wg"][i, t], params["wu"][i, t],
                        params["wd"][i, t], y[i])
            parts.append(pairs_of(y).float().sum(3))
    return torch.stack(parts, dim=1).to(x.dtype)


# the MoE shapes of tests/test_torch_families.py's serves (smoke configs):
# the stage-stacked pipeline call [N 8, B 2, C 16, d], the forward's
# [B 2, S 24, d], and the manual TP lowering's expert-parallel and
# f-sharded calls at tp 2
MOE_SHAPES = {"pipeline": (8, 2, 16, 0), "forward": (0, 2, 24, 0), "ep_tp2": (8, 2, 16, 2),
              "f_sharded_tp2": (8, 2, 16, -2)}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_equals_its_out_path_and_differentiates(arch, shape, dtype):
    cfg = get_smoke_config(arch)
    m = cfg.moe
    g, b, s, tp = MOE_SHAPES[shape]
    d, e, f = cfg.d_model, m.num_experts, m.d_expert or cfg.d_ff
    gen = torch.Generator().manual_seed(2)
    lead = (g,) if g else ()

    def nrm(*sh, std=0.1):
        return (torch.randn(sh, generator=gen) * std).to(dtype)
    p = {"router": nrm(*lead, d, e, std=0.3)}
    if tp > 0:              # expert parallel: [G, tp, E / tp, ...]
        p.update(wg=nrm(g, tp, e // tp, d, f), wu=nrm(g, tp, e // tp, d, f),
                 wd=nrm(g, tp, e // tp, f, d))
    elif tp < 0:            # f-sharded: [G, tp, E, d, f / tp]
        p.update(wg=nrm(g, -tp, e, d, f // -tp), wu=nrm(g, -tp, e, d, f // -tp),
                 wd=nrm(g, -tp, e, f // -tp, d))
    else:
        p.update(wg=nrm(*lead, e, d, f), wu=nrm(*lead, e, d, f), wd=nrm(*lead, e, f, d))
    x = nrm(*lead, b, s, d, std=1.0)
    kw = dict(num_experts=e, top_k=m.top_k, capacity_factor=m.capacity_factor,
              num_real=m.real_experts, sharded=tp != 0, ep=tp > 0)
    want = _moe_layer_with_out(p, x, **kw)
    got = L.moe_layer(p, x, **kw)
    assert torch.equal(got, want)
    if dtype == torch.float32:      # and autograd reaches every expert weight
        pg = {n: w.clone().requires_grad_(True) for n, w in p.items()}
        grads = torch.autograd.grad(L.moe_layer(pg, x, **kw).square().sum(), list(pg.values()))
        assert all(gr.abs().sum() > 0 for gr in grads)
