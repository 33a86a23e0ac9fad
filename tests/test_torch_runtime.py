"""The port's data stream, checkpoints, train CLI and blocked flash
attention against the JAX reference on the CPU:

- ``repro_torch.data.SyntheticLM`` batches equal the reference's exactly,
  for several (seed, shard, num_shards) and steps, and after ``restore``;
- ``runtime.checkpoint``: a round trip of fp32, bf16, fp8 and int32
  leaves (bit for bit), atomic saves and ``latest_step``, a corrupted file
  refused; a reference train state bridged to the port and saved by it
  writes the same files, byte for byte (so the same sha256s), as
  ``repro.runtime.checkpoint``'s save of the original, and each package
  restores the other's checkpoint with equal values; restore runs on the
  card unless asked for the CPU;
- the train CLI on the CPU: a checkpoint, ``--resume`` from it, and the
  same losses and final checkpoint, file for file, as an uninterrupted
  run; without a card it refuses; the training modules import without
  nvcc and build nothing;
- ``layers.flash_attention_xla`` (the training path's attention) and its
  gradients against the reference's over several key blocks (block_k 16),
  causal, offset and non-causal: within 1e-5 of each one's max."""
import filecmp
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import layers as RL
from repro.models.api import build_model as ref_build
from repro.runtime import checkpoint as RC
from repro.train import step as RS
from repro_torch import bridge
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as cli
from repro_torch.models import layers as L
from repro_torch.runtime import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.optim import leaves
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


# -------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (5, 1, 2), (11, 3, 4)])
def test_synthetic_lm_matches_reference(seed, shard, num_shards):
    kw = dict(seed=seed, shard=shard, num_shards=num_shards)
    ref, got = RefSyntheticLM(1000, 48, 8, **kw), SyntheticLM(1000, 48, 8, **kw)
    want = [ref.next_batch() for _ in range(5)]
    for w in want:
        g = got.next_batch()
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    # resume: a fresh stream restored at step 2 replays steps 2..4
    again = SyntheticLM(1000, 48, 8, **kw)
    again.restore(RefSyntheticLM(1000, 48, 8, **kw).checkpoint() | {"step": 2})
    for w in want[2:]:
        assert np.array_equal(again.next_batch()["tokens"], w["tokens"])
    assert got.checkpoint() == ref.checkpoint() == {"seed": seed, "step": 5}
    with pytest.raises(AssertionError):
        again.restore({"seed": seed + 1, "step": 0})


# -------------------------------------------------------------- checkpoint

def _mixed_tree():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn((3, 4), generator=gen),
            "sub": {"bf": torch.randn((5, 2), generator=gen).to(torch.bfloat16),
                    "fp8": torch.randn((2, 3), generator=gen).to(torch.float8_e4m3fn),
                    "i": torch.arange(4, dtype=torch.int32),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    tree = _mixed_tree()
    path = save_checkpoint(str(tmp_path), 3, tree, extra={"data": {"seed": 1, "step": 3}})
    assert os.path.basename(path) == "step_00000003"
    got, extra = restore_checkpoint(str(tmp_path), device="cpu")
    assert extra == {"data": {"seed": 1, "step": 3}}
    for a, b in zip(leaves(got), leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
    meta = json.load(open(os.path.join(path, "manifest.json")))["leaves"]
    assert meta["sub/bf"]["dtype"] == "bfloat16" and meta["sub/fp8"]["dtype"] == "float8_e4m3fn"
    assert np.load(os.path.join(path, "sub__bf.npy")).dtype == np.uint16


def test_checkpoint_is_atomic_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None and latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, device="cpu")
    tree = _mixed_tree()
    save_checkpoint(d, 1, tree)
    save_checkpoint(d, 3, tree)
    # a save that died half way leaves only its .tmp directory: never "latest"
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "w.npy").write_bytes(b"torn")
    assert latest_step(d) == 3
    # the next save of that step clears the torn one; a save of the same step replaces
    save_checkpoint(d, 9, tree)
    assert not (tmp_path / "step_00000009.tmp").exists() and latest_step(d) == 9
    tree["w"] += 1
    save_checkpoint(d, 9, tree)
    got, _ = restore_checkpoint(d, device="cpu")
    assert torch.equal(got["w"], tree["w"])
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000003", "step_00000009"]


def test_checkpoint_refuses_a_corrupted_file(tmp_path):
    path = save_checkpoint(str(tmp_path), 2, _mixed_tree())
    f = os.path.join(path, "sub__bf.npy")
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch for sub/bf"):
        restore_checkpoint(str(tmp_path), device="cpu")
    got, _ = restore_checkpoint(str(tmp_path), device="cpu", verify=False)
    assert not torch.equal(got["sub"]["bf"], _mixed_tree()["sub"]["bf"])


def test_restore_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, _mixed_tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        restore_checkpoint(str(tmp_path))


def _ref_tree():
    """A reference train state (bf16 params, fp32 moments, int32 step) and
    an fp8 leaf, as numpy (ml_dtypes) arrays."""
    model = ref_build(ref_smoke("qwen3-8b"))
    state = jax.tree.map(np.asarray, RS.init_train_state(model, jax.random.key(0)))
    rng = np.random.default_rng(0)
    state["opt"]["m"]["embed"] = rng.standard_normal(state["opt"]["m"]["embed"].shape).astype(
        np.float32)
    state["opt"]["step"] = np.asarray(np.int32(12))
    fp8 = rng.standard_normal((4, 8)).astype(ml_dtypes.float8_e4m3fn)
    return state, fp8


def test_checkpoint_files_equal_the_reference_and_restore_across(tmp_path):
    state, fp8 = _ref_tree()
    extra = {"data": {"seed": 0, "step": 12}, "step": 12}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RC.save_checkpoint(ref_dir, 12, {"state": state, "fp8": jnp.asarray(fp8)}, extra=extra)
    ported = bridge.train_state_from_numpy(state, device="cpu")
    save_checkpoint(port_dir, 12, {"state": ported,
                                   "fp8": bridge.tensor_from_numpy(fp8, device="cpu")},
                    extra=extra)
    a, b = os.path.join(ref_dir, "step_00000012"), os.path.join(port_dir, "step_00000012")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 10
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors          # manifest.json (every sha256) included
    # the port restores the reference's checkpoint ...
    got, got_extra = restore_checkpoint(ref_dir, device="cpu")
    assert got_extra == extra
    assert got["state"]["params"]["embed"].dtype == torch.bfloat16
    want_tree = {"state": ported, "fp8": bridge.tensor_from_numpy(fp8, device="cpu")}
    for t, want in zip(leaves(got), leaves(want_tree)):
        assert t.dtype == want.dtype and np.array_equal(_bits(t), _bits(want))
    # ... and the reference restores the port's
    back, back_extra = RC.restore_checkpoint(port_dir)
    assert back_extra == extra
    want_leaves = jax.tree.leaves({"state": state, "fp8": fp8})
    for t, want in zip(jax.tree.leaves(back), want_leaves):
        t = np.asarray(t)
        assert t.dtype == want.dtype and t.shape == want.shape
        assert t.tobytes() == np.asarray(want).tobytes()


# -------------------------------------------------------------------- CLI

@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-small"])
def test_train_cli_resume_is_bit_exact_on_cpu(tmp_path, arch):
    """12 steps with a checkpoint at 6, then a run resumed from step 6 (its
    own directory): the same losses and the same final checkpoint, file
    for file."""
    base = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--steps", "12",
            "--batch", "4", "--seq", "32", "--log-every", "4"]
    full, half = tmp_path / "full", tmp_path / "half"
    assert cli.main(base + ["--ckpt-dir", str(full), "--ckpt-every", "6",
                            "--metrics-out", str(tmp_path / "full.jsonl")]) == 0
    assert latest_step(str(full)) == 12
    half.mkdir()
    os.rename(full / "step_00000006", half / "step_00000006")
    assert cli.main(base + ["--ckpt-dir", str(half), "--resume", "--ckpt-every", "6",
                            "--metrics-out", str(tmp_path / "half.jsonl")]) == 0
    read = lambda p: [json.loads(x) for x in open(p)]
    assert read(tmp_path / "full.jsonl")[6:] == read(tmp_path / "half.jsonl")
    a, b = full / "step_00000012", half / "step_00000012"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def test_train_modules_import_without_nvcc():
    """The train, data, checkpoint and train-CLI modules import without
    nvcc and build nothing (no kernel lies on the training path)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PATH="/nonexistent")
    code = ("import repro_torch.train, repro_torch.train.step, repro_torch.data, "
            "repro_torch.runtime.checkpoint, repro_torch.launch.train; "
            "import repro_torch.kernels.build as b, repro_torch.kernels.ops as ops; "
            "assert not b._LIBS and all(v == 0 for v in ops.LAUNCHES.values()); print('OK')")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_train_cli_refuses_without_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--preset", "smoke",
                        "--steps", "1"], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "RuntimeError" in r.stderr


def _close_max(got: torch.Tensor, want, rtol: float, what: str) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("off", [0, 7, None])
def test_flash_attention_xla_and_grads_match_reference(off):
    """Four key blocks of 16 (the last padded) over GQA heads: the output
    and d(sum(out * w)) / d(q, k, v) against ``jax.grad`` of the
    reference's, within 1e-5 of each one's max."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 21, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 57, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 57, 2, 8)).astype(np.float32)
    w = rng.standard_normal((2, 21, 4, 8)).astype(np.float32)

    def ref(q, k, v):
        return jnp.sum(RL.flash_attention_xla(q, k, v, causal_offset=off, block_k=16) * w)
    want, wgrads = jax.value_and_grad(ref, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = L.flash_attention_xla(tq, tk, tv, causal_offset=off, block_k=16)
    got = torch.sum(out * torch.from_numpy(w))
    got.backward()
    _close_max(out, RL.flash_attention_xla(q, k, v, causal_offset=off, block_k=16), 1e-5, "out")
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for t, g, name in zip((tq, tk, tv), wgrads, "qkv"):
        _close_max(t.grad, g, 1e-5, f"d{name}")
