"""The port's checkpoints (``repro_torch.checkpoint.store``) on the CPU: the
save/restore protocol (atomic staging, LATEST, crc32, newest-valid fallback,
keep-last-k, injected IO failures, async saves) and the on-disk format,
which is the JAX package's: a checkpoint written by either package restores
into the other with identical leaf names and bit-identical arrays, and a
port Trainer resumes from a JAX Trainer's checkpoint directory.
"""
import json
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params
from repro.checkpoint import store as jax_store
from repro.core.labels import flatten_with_names as jax_flatten
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.optim import schedules as jax_schedules
from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.train.trainer import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import AsyncCheckpointer, ChecksumError, latest_step, named_leaves, restore, save
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.models import Transformer
from repro_torch.optim import schedules
from repro_torch.train import Trainer, TrainerConfig, inject_checkpoint_io_failure, tear_checkpoint
from repro_torch.train.trainer import make_optimizer

DATA = dict(vocab_size=211, seq_len=16, global_batch=4, seed=3)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g), "b.x": torch.randn(5, generator=g)},
            "opt": (torch.tensor(seed, dtype=torch.int32), None, {"mu": torch.randn(2, 2, generator=g)})}


def _assert_same(a, b):
    na, nb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (name, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_save_restore_round_trip(tmp_path):
    path = save(tmp_path, 7, _tree(1), extra={"step": 7})
    assert path.name == "step_00000007" and (tmp_path / "LATEST").read_text() == path.name
    manifest = json.loads((path / "manifest.json").read_text())
    assert list(manifest["leaves"]) == ["opt.0", "opt.2.mu", "params.b.x", "params.w"]
    assert all("crc32" in e for e in manifest["leaves"].values())
    got, extra = restore(tmp_path, _tree(2))
    assert extra == {"step": 7} and latest_step(tmp_path) == 7
    _assert_same(got, _tree(1))
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, {"params": {"w": torch.zeros(4, 3)}})
    with pytest.raises(KeyError):
        restore(tmp_path, {"params": {"missing": torch.zeros(1)}})


def test_torn_step_falls_back_and_crc_mismatch_raises(tmp_path):
    for step in (2, 4):
        save(tmp_path, step, _tree(step))
    assert tear_checkpoint(tmp_path) == 4
    with pytest.warns(UserWarning, match="falling back"):
        got, _ = restore(tmp_path, _tree(0))
    _assert_same(got, _tree(2))
    with pytest.raises((zipfile.BadZipFile, ChecksumError, OSError, EOFError)):
        restore(tmp_path, _tree(0), step=4)
    # only the manifest's checksum wrong: a ChecksumError names the leaf
    path = tmp_path / "step_00000002"
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["leaves"]["params.w"]["crc32"] ^= 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ChecksumError, match="params.w"):
        restore(tmp_path, _tree(0), step=2)
    with pytest.warns(UserWarning), pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        restore(tmp_path, _tree(0))


def test_keep_last_k_and_latest_pointer(tmp_path):
    for step in range(1, 6):
        save(tmp_path, step, _tree(step), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000004", "step_00000005"]
    (tmp_path / "LATEST").write_text("step_00000009")         # stale pointer: scan instead
    assert latest_step(tmp_path) == 5
    assert not list(tmp_path.glob("*.tmp"))


def test_injected_io_failure_is_counted_and_leaves_no_step(tmp_path):
    cfg = get_reduced("gpt_small")
    tc = TrainerConfig(total_steps=2, log_every=1, ckpt_every=1, ckpt_dir=str(tmp_path), backend="fused")
    tr = Trainer(cfg, "slim", 1e-3, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)), tc,
                 device="cpu")
    with inject_checkpoint_io_failure(fail_on=(1,)) as state, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr.run()
    assert state == {"calls": 2, "failed": 1} and tr.ckpt_failures == 1
    assert [p.name for p in tmp_path.glob("step_*")] == ["step_00000002"]
    assert not list(tmp_path.glob("*.tmp"))


def test_async_checkpointer_retries_and_reports(tmp_path):
    acp = AsyncCheckpointer(max_retries=2, backoff_s=0.001)
    tree = _tree(4)
    with inject_checkpoint_io_failure(fail_on=(1,)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        acp.save(tmp_path, 1, tree)
        tree["params"]["w"].add_(1.0)          # the save holds its own host copy
        acp.wait()
    got, _ = restore(tmp_path, _tree(0))
    _assert_same(got, _tree(4))
    with inject_checkpoint_io_failure(fail_on=(1, 2, 3)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        acp.save(tmp_path, 2, tree)
        with pytest.raises(RuntimeError, match="step 2"):
            acp.wait()


# -- cross-package ------------------------------------------------------------


def _states(name):
    """(JAX state, port state) after one update from the same params and
    gradients, with a warmup-cosine schedule (whose count is a leaf)."""
    _, jparams, jmeta, arrays = jax_params(seed=2)
    jtx = jax_make_optimizer(name, jax_schedules.warmup_cosine(1e-3, 2, 10), jparams, jmeta, backend="jnp")
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    model.load_params(params_from_numpy(arrays, "cpu"))
    ttx = make_optimizer(name, schedules.warmup_cosine(1e-3, 2, 10), model.params, model.meta)
    rng = np.random.default_rng(11)
    g = {k: rng.standard_normal(a.shape).astype(np.float32) for k, a in arrays.items()}
    jgrads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(g[k]) for k in arrays])
    _, jstate = jax.jit(jtx.update)(jgrads, jtx.init(jparams), jparams)
    with torch.no_grad():
        _, tstate = ttx.update({k: torch.from_numpy(x) for k, x in g.items()}, ttx.init(model.params), model.params)
    return {"params": jparams, "opt": jstate}, {"params": model.params, "opt": tstate}


# The leaves that pin each optimizer's chain layout: the schedule's count at
# index 3 (clip, core, wd, lr; sgdm: clip, wd, momentum, lr), and each core
# state's own fields (Adafactor's mu only with momentum, SM3's per-axis
# accumulators as tuple entries).
LAYOUT = {
    "adam": ("opt.inner_states.1.count",),
    "slim": ("opt.inner_states.1.count",),
    "adalayer": ("opt.inner_states.1.count", "opt.inner_states.1.nu.embed"),
    "adafactor": ("opt.inner_states.1.count", "opt.inner_states.1.vc.final_norm.scale"),
    "adafactor_v2": ("opt.inner_states.1.count", "opt.inner_states.1.mu.embed"),
    "sm3": ("opt.inner_states.1.accs.embed.0", "opt.inner_states.1.accs.embed.1", "opt.inner_states.1.mom.embed"),
    "lion": ("opt.inner_states.1.mu.embed",),
    "sgdm": ("opt.inner_states.2.trace.embed",),
}


@pytest.mark.parametrize("name", list(LAYOUT))
def test_cross_package_restore_both_ways(tmp_path, name):
    jtree, ttree = _states(name)
    jnamed = [(n, np.asarray(x)) for n, x in jax_flatten(jtree)[0]]
    tnamed = named_leaves(ttree)
    assert [n for n, _ in jnamed] == [n for n, _ in tnamed]
    for leaf in LAYOUT[name] + ("opt.inner_states.3.count",):
        assert leaf in dict(jnamed), leaf
    if name == "adafactor":
        assert not any(".mu." in n for n, _ in jnamed)

    jax_store.save(tmp_path / "from_jax", 1, jtree, extra={"step": 1})
    got, extra = restore(tmp_path / "from_jax", ttree)
    assert extra == {"step": 1}
    for (n, want), (m, leaf) in zip(jnamed, named_leaves(got)):
        assert n == m and str(leaf.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=n)

    save(tmp_path / "from_port", 1, ttree, extra={"step": 1})
    back, _ = jax_store.restore(tmp_path / "from_port", jtree)
    for (n, leaf), (m, want) in zip(jax_flatten(back)[0], tnamed):
        assert n == m
        np.testing.assert_array_equal(np.asarray(leaf), want.detach().numpy(), err_msg=n)


def test_port_trainer_resumes_a_jax_run(tmp_path):
    jcfg, _, _, _ = jax_params(seed=0)
    jtr = JaxTrainer(jcfg, "slim", 3e-3, JaxZipfLM(JaxDataConfig(**DATA)),
                     JaxTrainerConfig(total_steps=4, log_every=1, ckpt_every=2, ckpt_dir=str(tmp_path), seed=0))
    jtr.run()
    tr = Trainer(get_reduced("gpt_small"), "slim", 3e-3, ZipfLM(DataConfig(**DATA)),
                 TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path), seed=0), device="cpu")
    assert tr.step == 4
    want = {n: np.asarray(x) for n, x in jax_flatten(jtr.params)[0]}
    for n, p in tr.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    last = tr.run()           # already at the target: a forward-only eval
    assert last["step"] == 4 and last["grad_norm"] == 0.0 and np.isfinite(last["loss"])
