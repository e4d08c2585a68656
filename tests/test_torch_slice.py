"""The port's slice end to end on reduced gpt_small, against the JAX trainer:

* 20 SlimAdam (Table-3) steps from the same initial parameters and ZipfLM
  batches give the same loss curve within 1e-3 relative (f32 reassociation
  accumulates over the steps);
* an Adam run measuring SNR derives the same SlimAdam rules;
* no file of the port imports JAX or the JAX package;
* entry points without a device raise where no GPU is present (the
  trainer, the CLIs, the mesh), and run when the CPU is asked for.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_params
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import main as launch_main
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.__main__ import main as cli_main

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(vocab_size=211, seq_len=32, global_batch=4, seed=5)
LR = 3e-3


def _pair(optimizer, steps, **tc_kw):
    """(JAX trainer, port trainer) after ``steps``, from the same params."""
    jcfg, _, _, arrays = jax_params(seed=0)
    jtr = JaxTrainer(jcfg, optimizer, LR, JaxZipfLM(JaxDataConfig(**DATA)),
                     JaxTrainerConfig(total_steps=steps, log_every=1, seed=0, backend="jnp", **tc_kw))
    jtr.run()
    ttr = Trainer(get_reduced("gpt_small"), optimizer, LR, ZipfLM(DataConfig(**DATA)),
                  TrainerConfig(total_steps=steps, log_every=1, seed=0, backend="fused", **tc_kw),
                  device="cpu")
    ttr.model.load_params(params_from_numpy(arrays, "cpu"))
    ttr.run()
    return jtr, ttr


def test_slim_loss_curve_matches_jax():
    jtr, ttr = _pair("slim", 20)
    want = [m["loss"] for m in jtr.metrics_log]
    got = [m["loss"] for m in ttr.metrics_log]
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]


def test_adam_snr_derives_the_same_rules_as_jax():
    jtr, ttr = _pair("adam", 10, measure_snr=True, snr_early_every=5)
    assert ttr.snr.steps == jtr.snr.steps == [5, 10]
    assert ttr.derive_slim_rules() == jtr.derive_slim_rules()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"


def test_entry_points_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    data = ZipfLM(DataConfig(**DATA))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_reduced("gpt_small"), "slim", LR, data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_main(["--arch", "gpt_small", "--steps", "1"])
    launch_main(["--arch", "gpt_small", "--steps", "2", "--seq", "16", "--batch", "2"], device="cpu")
